"""TextMatcher, the base of the text-matching models (port of
``analytics_zoo_tpu/models/textmatching/text_matcher.py``): the shared
hyperparameters (text1 length, vocabulary, embedding, ranking or
classification target) and the Ranker's NDCG and MAP; KNRM builds its
graph on it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.models.common import Ranker, ZooModel


class TextMatcher(ZooModel, Ranker):
    """Base for text matchers scoring (text1, text2) pairs.

    ``target_mode``: "ranking" (pairwise rank-hinge training over
    alternating positive/negative rows) or "classification" (sigmoid
    relevance probability) — the reference's two training regimes.
    """

    def __init__(self, text1_length: int, vocab_size: int,
                 embed_size: int = 300,
                 embed_weights: Optional[np.ndarray] = None,
                 train_embed: bool = True,
                 target_mode: str = "ranking"):
        super().__init__()
        if target_mode not in ("ranking", "classification"):
            raise ValueError(
                "target_mode must be ranking|classification, got "
                f"{target_mode!r}")
        self.text1_length = int(text1_length)
        self.vocab_size = int(vocab_size)
        self.embed_size = int(embed_size)
        self.embed_weights = embed_weights
        self.train_embed = bool(train_embed)
        self.target_mode = target_mode
