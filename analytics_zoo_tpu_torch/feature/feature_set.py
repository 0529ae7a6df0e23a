"""Datasets for the Estimator (port of
``analytics_zoo_tpu/feature/feature_set.py``). So far its label rule,
:func:`normalize_labels`, which ``pipeline.estimator.ArrayDataset``
reads user labels by; the cached, sharded ``FeatureSet`` comes later."""

from __future__ import annotations

import numpy as np


def normalize_labels(y):
    """How user-supplied labels are read: returns ``(y_cols, multi)``,
    ``y_cols`` a list of numpy label columns (empty: unlabeled) and
    ``multi`` whether they are separate output columns.

    A list or tuple of array-likes (objects with ``ndim >= 1``: numpy
    arrays or tensors) is several columns, one per model output:
    ``[ya, yb]`` stays two. A plain Python list of per-sample scalars or
    rows (``[0, 1, 0, 1]`` or ``[[0], [1]]``) is one label array. An
    empty list raises: pass None for unlabeled data."""
    if y is None:
        return [], False
    if isinstance(y, (list, tuple)):
        if len(y) == 0:
            raise ValueError(
                "empty label list — pass None for unlabeled data")
        if all(getattr(c, "ndim", 0) >= 1 for c in y):
            return [np.asarray(c) for c in y], True
    return [np.asarray(y)], False
