"""NeuralCF: neural collaborative filtering, GMF + MLP (port of
``analytics_zoo_tpu/models/recommendation/neuralcf.py``).

Input: (batch, 2) int [user_id, item_id], ids 0-based. Output:
log-probabilities over ``num_classes``. The layer names
(``user_id``, ``item_id``, ``mlp_user_table``, ``mlp_item_table``,
``mf_user_table``, ``mf_item_table``, then the auto-named Dense layers)
are the JAX package's, so params and weight files cross unchanged.
"""

from __future__ import annotations

from typing import Sequence

from analytics_zoo_tpu_torch.models.recommendation.recommender import \
    Recommender
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Activation, Concatenate, Dense, Embedding, Multiply, Select)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model


class NeuralCF(Recommender):
    def __init__(self, user_count: int, item_count: int, num_classes: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20):
        super().__init__()
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.num_classes = int(num_classes)
        self.user_embed = int(user_embed)
        self.item_embed = int(item_embed)
        self.hidden_layers = tuple(int(h) for h in hidden_layers)
        self.include_mf = bool(include_mf)
        self.mf_embed = int(mf_embed)

    def hyper_parameters(self):
        return {
            "user_count": self.user_count,
            "item_count": self.item_count,
            "num_classes": self.num_classes,
            "user_embed": self.user_embed,
            "item_embed": self.item_embed,
            "hidden_layers": self.hidden_layers,
            "include_mf": self.include_mf,
            "mf_embed": self.mf_embed,
        }

    def build_model(self) -> Model:
        inp = Input((2,), name="user_item")
        user = Select(1, 0, name="user_id")(inp)
        item = Select(1, 1, name="item_id")(inp)

        mlp_u = Embedding(self.user_count, self.user_embed,
                          init="normal", name="mlp_user_table")(user)
        mlp_i = Embedding(self.item_count, self.item_embed,
                          init="normal", name="mlp_item_table")(item)
        x = Concatenate(axis=-1)([mlp_u, mlp_i])
        for h in self.hidden_layers:
            x = Dense(h, activation="relu")(x)

        if self.include_mf:
            if self.mf_embed <= 0:
                raise ValueError("mf_embed must be positive")
            mf_u = Embedding(self.user_count, self.mf_embed,
                             init="normal", name="mf_user_table")(user)
            mf_i = Embedding(self.item_count, self.mf_embed,
                             init="normal", name="mf_item_table")(item)
            gmf = Multiply()([mf_u, mf_i])
            x = Concatenate(axis=-1)([gmf, x])
        out = Dense(self.num_classes)(x)
        out = Activation("log_softmax")(out)
        return Model(inp, out, name="neuralcf")
