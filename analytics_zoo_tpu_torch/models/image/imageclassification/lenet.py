"""LeNet-5 (port of
``analytics_zoo_tpu/models/image/imageclassification/lenet.py``):
BASELINE's first configuration, LeNet-5 on MNIST through the Keras
API."""

from __future__ import annotations

from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution2D, Dense, Dropout, Flatten, MaxPooling2D)
from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential


def lenet5(input_shape=(28, 28, 1), classes: int = 10,
           dropout: float = 0.5) -> Sequential:
    m = Sequential(name="lenet5")
    m.add(Convolution2D(32, 5, 5, activation="relu", border_mode="same",
                        input_shape=input_shape))
    m.add(MaxPooling2D())
    m.add(Convolution2D(64, 5, 5, activation="relu", border_mode="same"))
    m.add(MaxPooling2D())
    m.add(Flatten())
    m.add(Dense(512, activation="relu"))
    m.add(Dropout(dropout))
    m.add(Dense(classes, activation="softmax"))
    return m
