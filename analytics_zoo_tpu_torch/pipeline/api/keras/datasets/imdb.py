"""IMDB sentiment loader (port of
``analytics_zoo_tpu/pipeline/api/keras/datasets/imdb.py``).

Reads the reference's cached ``imdb_full.pkl`` (a pickled
``((x_train, y_train), (x_test, y_test))`` of index sequences) when
present, else a seeded synthetic stand-in. ``nb_words``/``oov_char``
follow the reference's truncation contract (`imdb.py:40-76`).
"""

from __future__ import annotations

import os

import numpy as np

from analytics_zoo_tpu_torch.common.safe_pickle import CheckedUnpickler
from analytics_zoo_tpu_torch.pipeline.api.keras.datasets._base import (
    DEFAULT_DIR, apply_nb_words, cache_path, synthetic_notice,
    synthetic_sequences)

_VOCAB = 20000


def load_data(dest_dir=DEFAULT_DIR, nb_words=None, oov_char=2):
    path = cache_path(dest_dir, "imdb_full.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            # lists/ints only — the checked unpickler rejects anything
            # with a reduce gadget
            (x_train, y_train), (x_test, y_test) = \
                CheckedUnpickler(f).load()
    else:
        synthetic_notice("imdb", f"no cache at {path}")
        x_train = synthetic_sequences(512, _VOCAB, seed=10)
        x_test = synthetic_sequences(128, _VOCAB, seed=11)
        rs = np.random.RandomState(12)
        y_train = list(rs.randint(0, 2, size=len(x_train)))
        y_test = list(rs.randint(0, 2, size=len(x_test)))
    x_train = apply_nb_words(x_train, nb_words, oov_char)
    x_test = apply_nb_words(x_test, nb_words, oov_char)
    return (x_train, y_train), (x_test, y_test)
