"""KNRM, the kernel-pooling neural ranking model (port of
``analytics_zoo_tpu/models/textmatching/knrm.py``), on the autograd
operators.

Input: (batch, text1_length + text2_length) ids, the two texts
concatenated and sliced apart after one embedding, as the reference's.
Output: one score per row. ``target_mode="ranking"`` trains with
``rank_hinge`` (rows alternate positive and negative, the layout of
``TextSet.from_relation_pairs``); ``"classification"`` ends in a
sigmoid. The ``Ranker`` mixin gives NDCG and MAP over relation lists.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.models.textmatching.text_matcher import \
    TextMatcher
from analytics_zoo_tpu_torch.pipeline.api import autograd as A
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense, Embedding, WordEmbedding)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model


class KNRM(TextMatcher):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int, embed_size: int = 300,
                 embed_weights: Optional[np.ndarray] = None,
                 train_embed: bool = True, kernel_num: int = 21,
                 sigma: float = 0.1, exact_sigma: float = 0.001,
                 target_mode: str = "ranking"):
        super().__init__(text1_length, vocab_size,
                         embed_size=embed_size,
                         embed_weights=embed_weights,
                         train_embed=train_embed,
                         target_mode=target_mode)
        if kernel_num <= 1:
            raise ValueError("kernel_num must be > 1")
        self.text2_length = int(text2_length)
        self.kernel_num = int(kernel_num)
        self.sigma = float(sigma)
        self.exact_sigma = float(exact_sigma)

    def hyper_parameters(self):
        return {"text1_length": self.text1_length,
                "text2_length": self.text2_length,
                "vocab_size": self.vocab_size,
                "embed_size": self.embed_size,
                "train_embed": self.train_embed,
                "kernel_num": self.kernel_num,
                "sigma": self.sigma,
                "exact_sigma": self.exact_sigma,
                "target_mode": self.target_mode}

    def build_model(self) -> Model:
        t1, t2 = self.text1_length, self.text2_length
        inp = Input((t1 + t2,), name="concat_ids")
        if self.embed_weights is not None:
            embed_layer = WordEmbedding(self.embed_weights,
                                        trainable=self.train_embed,
                                        name="embedding")
        else:
            embed_layer = Embedding(self.vocab_size, self.embed_size,
                                    init="uniform", name="embedding")
            embed_layer.trainable = self.train_embed
        embedding = embed_layer(inp)
        text1 = embedding[0:t1]
        text2 = embedding[t1:t1 + t2]
        # translation matrix: (B, t1, t2)
        mm = A.batch_dot(text1, text2, axes=(2, 2))
        kernels = []
        for i in range(self.kernel_num):
            mu = 1.0 / (self.kernel_num - 1) + \
                (2.0 * i) / (self.kernel_num - 1) - 1.0
            if mu > 1.0:  # exact-match kernel
                mu = 1.0
                sigma = self.exact_sigma
            else:
                sigma = self.sigma
            mm_exp = A.exp((mm - mu) * (mm - mu) *
                           (-0.5 / (sigma * sigma)))
            mm_doc_sum = A.sum(mm_exp, axis=2)
            mm_log = A.log(mm_doc_sum + 1.0)
            kernels.append(A.sum(mm_log, axis=1, keepdims=True))
        phi = A.squeeze(A.stack(kernels, axis=1), dim=2)
        if self.target_mode == "ranking":
            out = Dense(1, init="uniform", name="score")(phi)
        else:
            out = Dense(1, init="uniform", activation="sigmoid",
                        name="score")(phi)
        return Model(inp, out, name="knrm")

    # -- convenience for relation data --------------------------------------
    @staticmethod
    def concat_inputs(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
        return np.concatenate([x1, x2], axis=1)

    def evaluate_ndcg_on_relations(self, x1, x2, labels, group_ids,
                                   k: int = 3, batch_size: int = 128
                                   ) -> float:
        scores = self.predict(self.concat_inputs(x1, x2),
                              batch_size=batch_size)
        return self.evaluate_ndcg(scores, labels, group_ids, k=k)

    def evaluate_map_on_relations(self, x1, x2, labels, group_ids,
                                  batch_size: int = 128) -> float:
        scores = self.predict(self.concat_inputs(x1, x2),
                              batch_size=batch_size)
        return self.evaluate_map(scores, labels, group_ids)
