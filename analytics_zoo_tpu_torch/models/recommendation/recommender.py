"""Recommender base (port of
``analytics_zoo_tpu/models/recommendation/recommender.py``):
``predict_user_item_pair``, ``recommend_for_user`` and
``recommend_for_item`` over user-item pair features. The models output
log-probabilities over rating classes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from analytics_zoo_tpu_torch.models.common import ZooModel


@dataclass
class UserItemFeature:
    user_id: int
    item_id: int
    feature: Any  # the model's input row (an array, or a list of them)


@dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender(ZooModel):
    """Ranking helpers shared by the recommendation models."""

    def predict_user_item_pair(
            self, pairs: "list[UserItemFeature]",
            batch_size: int = 128) -> "list[UserItemPrediction]":
        """Each pair's most likely class and its probability."""
        feats = [p.feature for p in pairs]
        first = feats[0]
        if isinstance(first, (list, tuple)):
            x = [np.stack([f[i] for f in feats])
                 for i in range(len(first))]
        else:
            x = np.stack(feats)
        logp = self.predict(x, batch_size=batch_size)
        classes = np.argmax(logp, axis=-1)
        probs = np.exp(np.max(logp, axis=-1))
        return [UserItemPrediction(p.user_id, p.item_id, int(c), float(pr))
                for p, c, pr in zip(pairs, classes, probs)]

    @staticmethod
    def _top_k(preds: "list[UserItemPrediction]", key_fn, k: int
               ) -> "list[UserItemPrediction]":
        groups: "dict[int, list[UserItemPrediction]]" = {}
        for p in preds:
            groups.setdefault(key_fn(p), []).append(p)
        out: "list[UserItemPrediction]" = []
        for _, items in sorted(groups.items()):
            items.sort(key=lambda p: (-p.prediction, -p.probability))
            out.extend(items[:k])
        return out

    def recommend_for_user(self, pairs: "list[UserItemFeature]",
                           max_items: int) -> "list[UserItemPrediction]":
        """Per user (in id order), the ``max_items`` best items: the
        highest class first, then the highest probability."""
        preds = self.predict_user_item_pair(pairs)
        return self._top_k(preds, lambda p: p.user_id, max_items)

    def recommend_for_item(self, pairs: "list[UserItemFeature]",
                           max_users: int) -> "list[UserItemPrediction]":
        """Per item (in id order), the ``max_users`` best users."""
        preds = self.predict_user_item_pair(pairs)
        return self._top_k(preds, lambda p: p.item_id, max_users)
