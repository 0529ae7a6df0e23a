"""TextClassifier (port of ``analytics_zoo_tpu/models/textclassification/
text_classifier.py``): a CNN, LSTM or GRU encoder, then Dense(128),
Dropout(0.2), ReLU and Dense(class_num, softmax).

Two input modes, as the reference's:
- with an ``embedding`` layer (e.g. ``WordEmbedding.from_glove``): the
  input is (sequence_length,) token ids;
- without: the input is pre-embedded, (sequence_length, token_length).

A saved model records an ``Embedding`` or ``WordEmbedding`` front by
its shape (``hyper_parameters()["embedding"]``), and ``load_model``
rebuilds it before loading the weights. The reference records no
embedding, so its ``load_model`` builds the pre-embedded model and
refuses the saved weights.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.pipeline.api.keras.engine import KerasLayer
from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU, LSTM, Activation, Convolution1D, Dense, Dropout, Embedding,
    GlobalMaxPooling1D, WordEmbedding)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential


class TextClassifier(ZooModel):
    def __init__(self, class_num: int, token_length: int = 200,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256,
                 embedding: Optional[Union[KerasLayer, dict]] = None):
        super().__init__()
        if encoder.lower() not in ("cnn", "lstm", "gru"):
            raise ValueError(f"unsupported encoder {encoder}")
        self.class_num = int(class_num)
        self.token_length = int(token_length)
        self.sequence_length = int(sequence_length)
        self.encoder = encoder.lower()
        self.encoder_output_dim = int(encoder_output_dim)
        self.embedding = (_embedding_from_spec(embedding)
                          if isinstance(embedding, dict) else embedding)

    def hyper_parameters(self):
        hp = {"class_num": self.class_num,
              "token_length": self.token_length,
              "sequence_length": self.sequence_length,
              "encoder": self.encoder,
              "encoder_output_dim": self.encoder_output_dim}
        if self.embedding is not None:
            hp["embedding"] = _embedding_spec(self.embedding)
        return hp

    def build_model(self) -> Sequential:
        m = Sequential(name="text_classifier")
        if self.embedding is not None:
            if self.embedding._given_input_shape is None:
                self.embedding._given_input_shape = \
                    (self.sequence_length,)
            m.add(self.embedding)
            first_shape = None
        else:
            first_shape = (self.sequence_length, self.token_length)
        if self.encoder == "cnn":
            m.add(Convolution1D(self.encoder_output_dim, 5,
                                activation="relu",
                                input_shape=first_shape))
            m.add(GlobalMaxPooling1D())
        elif self.encoder == "lstm":
            m.add(LSTM(self.encoder_output_dim,
                       input_shape=first_shape))
        else:
            m.add(GRU(self.encoder_output_dim,
                      input_shape=first_shape))
        m.add(Dense(128))
        m.add(Dropout(0.2))
        m.add(Activation("relu"))
        m.add(Dense(self.class_num, activation="softmax"))
        return m


def _embedding_spec(layer: KerasLayer) -> dict:
    """An embedding front by its class and shape (its weights are saved
    with the rest)."""
    if not isinstance(layer, (Embedding, WordEmbedding)):
        raise ValueError(
            f"cannot save a TextClassifier whose embedding is a "
            f"{type(layer).__name__}: only Embedding and WordEmbedding "
            "are recorded")
    return {"class": type(layer).__name__, "input_dim": layer.input_dim,
            "output_dim": layer.output_dim,
            "trainable": bool(layer.trainable)}


def _embedding_from_spec(spec: dict) -> KerasLayer:
    if spec["class"] == "WordEmbedding":
        return WordEmbedding(
            np.zeros((spec["input_dim"], spec["output_dim"]), np.float32),
            trainable=spec["trainable"])
    if spec["class"] == "Embedding":
        layer = Embedding(spec["input_dim"], spec["output_dim"])
        layer.trainable = spec["trainable"]
        return layer
    raise ValueError(f"unknown embedding class {spec['class']!r}")
