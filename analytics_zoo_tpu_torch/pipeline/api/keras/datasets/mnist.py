"""MNIST loader (port of
``analytics_zoo_tpu/pipeline/api/keras/datasets/mnist.py``).

Reads the standard idx-gzip cache files when present (same names the
reference downloads: ``train-images-idx3-ubyte.gz`` etc.), else a
seeded synthetic stand-in. Normalization constants match the
reference (`mnist.py:24-27`).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.keras.datasets._base import (
    DEFAULT_DIR, synthetic_notice,
)

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255

_FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
              60000),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz",
             10000),
}


def _read32(stream):
    return np.frombuffer(stream.read(4),
                         np.dtype(np.uint32).newbyteorder(">"))[0]


def extract_images(f):
    """idx3 gzip → uint8 (n, 28, 28, 1) (reference `mnist.py:35-56`)."""
    with gzip.GzipFile(fileobj=f) as s:
        if _read32(s) != 2051:
            raise ValueError(f"bad magic in MNIST image file {f.name}")
        n, rows, cols = _read32(s), _read32(s), _read32(s)
        data = np.frombuffer(s.read(int(rows * cols * n)), np.uint8)
        return data.reshape(int(n), int(rows), int(cols), 1)


def extract_labels(f):
    with gzip.GzipFile(fileobj=f) as s:
        if _read32(s) != 2049:
            raise ValueError(f"bad magic in MNIST label file {f.name}")
        n = _read32(s)
        return np.frombuffer(s.read(int(n)), np.uint8)


def _synthetic(n, seed):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 10, size=n).astype(np.uint8)
    # blobby per-class patterns so a model can actually fit them
    base = rs.rand(10, 28, 28, 1) * 255
    x = base[y] * (0.6 + 0.4 * rs.rand(n, 28, 28, 1))
    return x.astype(np.uint8), y


def read_data_sets(train_dir, data_type="train"):
    """(features uint8 (n,28,28,1), labels uint8 (n,)) — reference
    `mnist.py:74-120` contract."""
    img_name, lbl_name, n = _FILES[data_type]
    img_path = os.path.join(train_dir, img_name)
    lbl_path = os.path.join(train_dir, lbl_name)
    if os.path.exists(img_path) and os.path.exists(lbl_path):
        with open(img_path, "rb") as f:
            images = extract_images(f)
        with open(lbl_path, "rb") as f:
            labels = extract_labels(f)
        return images, labels
    synthetic_notice("mnist", f"no cache at {img_path}")
    return _synthetic(min(n, 2048), seed=0 if data_type == "train"
                      else 1)


def load_data(location=os.path.join(DEFAULT_DIR, "mnist")):
    x_train, y_train = read_data_sets(location, "train")
    x_test, y_test = read_data_sets(location, "test")
    return (x_train, y_train), (x_test, y_test)
