"""Boston-housing regression loader (port of
``analytics_zoo_tpu/pipeline/api/keras/datasets/boston_housing.py``).

Reads the standard ``boston_housing.npz`` (keys ``x``, ``y``) when
present, else a seeded synthetic stand-in with the real 13-feature
shape. Same seeded shuffle + split contract as the reference
(`boston_housing.py:45-76`).
"""

from __future__ import annotations

import os

import numpy as np

from analytics_zoo_tpu_torch.pipeline.api.keras.datasets._base import (
    DEFAULT_DIR, cache_path, synthetic_notice)


def load_data(path="boston_housing.npz", dest_dir=DEFAULT_DIR,
              test_split=0.2):
    full = cache_path(dest_dir, path)
    if os.path.exists(full):
        with np.load(full, allow_pickle=False) as f:
            x, y = f["x"], f["y"]
    else:
        synthetic_notice("boston_housing", f"no cache at {full}")
        rs = np.random.RandomState(30)
        x = rs.rand(506, 13).astype(np.float64) * [100] * 13
        w = rs.randn(13)
        y = (x @ w / 50 + rs.randn(506) * 2 + 22).astype(np.float64)
    rs = np.random.RandomState(seed=113)          # reference seed
    idx = rs.permutation(len(x))
    x, y = x[idx], y[idx]
    n_test = int(len(x) * test_split)
    return ((x[n_test:], y[n_test:]), (x[:n_test], y[:n_test]))
