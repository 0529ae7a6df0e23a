"""FeatureSet, the cached training-set abstraction (port of
``analytics_zoo_tpu/feature/feature_set.py``, numpy only, kept as a
copy; the Scala original is ``Z/feature/FeatureSet.scala``, whose
``CachedDistributedFeatureSet`` caches samples per partition and
reshuffles an index permutation per epoch, ``:216-296``, with the memory
tiers DRAM / PMEM / DIRECT, ``:310-329``).

Each process caches its shard of the dataset (a row range) and hands
fixed-shape batches to the Estimator, which places them on the card.
Memory tiers:

- DRAM: materialised numpy arrays (the default, the fastest);
- DIRECT: the same arrays, no second copy (records are not re-read);
- PMEM: a disk-backed ``np.memmap`` arena (:class:`_MemmapStore`), for
  datasets larger than host memory; each batch's rows are read in
  ascending order.

:func:`normalize_labels` is the one rule by which user labels are read,
here and in ``pipeline.estimator.ArrayDataset``.
"""

from __future__ import annotations

import enum
import os
import tempfile
from typing import Any, Iterable, Iterator, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.feature.common import (Preprocessing, Sample,
                                                    _count_ingest)


class MemoryType(enum.Enum):
    DRAM = "dram"
    PMEM = "pmem"
    DIRECT = "direct"

    @staticmethod
    def of(v: "str | MemoryType") -> "MemoryType":
        if isinstance(v, MemoryType):
            return v
        return MemoryType(v.lower())


def _stack_column(column: "list[np.ndarray]") -> np.ndarray:
    return np.stack([np.asarray(a) for a in column], axis=0)


class _MemmapStore:
    """PMEM-tier store: columns spilled to a disk-backed memmap arena
    under ``path`` (a new temporary directory when None)."""

    def __init__(self, columns: "list[np.ndarray]", path: Optional[str]):
        self.dir = path or tempfile.mkdtemp(prefix="zoo_pmem_")
        os.makedirs(self.dir, exist_ok=True)
        self.columns = []
        for i, col in enumerate(columns):
            fname = os.path.join(self.dir, f"col{i}.mm")
            mm = np.memmap(fname, dtype=col.dtype, mode="w+",
                           shape=col.shape)
            mm[:] = col
            mm.flush()
            self.columns.append(mm)


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


class FeatureSet:
    """Cached, shardable dataset implementing the Estimator data protocol
    (`num_samples`, `iter_batches`).

    Build with :meth:`array`, :meth:`sample_rdd` (any iterable of
    `Sample`s — the RDD role), or :meth:`from_iterable` + a
    `Preprocessing` chain via :meth:`transform`.
    """

    def __init__(self, x_columns: "list[np.ndarray]",
                 y_column=None,
                 memory_type: "str | MemoryType" = MemoryType.DRAM,
                 shard_index: int = 0, num_shards: int = 1,
                 pmem_path: Optional[str] = None):
        self.memory_type = MemoryType.of(memory_type)
        n = x_columns[0].shape[0]
        for c in x_columns:
            if c.shape[0] != n:
                raise ValueError("inconsistent column lengths")
        # ``y_column``: one label array, or a list/tuple of them
        # (multi-output training); normalize_labels is the single decision
        # point for which is which
        y_cols, self._multi_y = normalize_labels(y_column)
        for c in y_cols:
            if c.ndim == 0 or c.shape[0] != n:
                raise ValueError(
                    f"label column shape {c.shape} does not match "
                    f"{n} samples")
        # multi-host sharding: this host keeps rows [lo, hi)
        if not (0 <= shard_index < num_shards):
            raise ValueError("bad shard spec")
        lo = shard_index * n // num_shards
        hi = (shard_index + 1) * n // num_shards
        x_columns = [c[lo:hi] for c in x_columns]
        y_cols = [c[lo:hi] for c in y_cols]

        if self.memory_type == MemoryType.PMEM:
            store = _MemmapStore(x_columns + y_cols, pmem_path)
            stored = store.columns
            self._x = stored[:len(x_columns)]
            y_cols = stored[len(x_columns):]
            self._store = store
        else:
            self._x = x_columns
        self._y_cols = y_cols
        self._n = self._x[0].shape[0]
        _count_ingest("feature_set", self._n,
                      sum(int(c.nbytes)
                          for c in list(self._x) + list(y_cols)))

    @property
    def _y(self):
        """Back-compat single-label view (None / array / list)."""
        if not self._y_cols:
            return None
        return list(self._y_cols) if self._multi_y else self._y_cols[0]

    # -- constructors (reference FeatureSet.rdd/array factories) -----------
    @staticmethod
    def array(x, y=None, memory_type="dram", **kw) -> "FeatureSet":
        xs = x if isinstance(x, (list, tuple)) else [x]
        xs = [np.asarray(a) for a in xs]
        return FeatureSet(xs, y, memory_type=memory_type, **kw)

    @staticmethod
    def sample_rdd(samples: Iterable[Sample], memory_type="dram",
                   **kw) -> "FeatureSet":
        """Materialize an iterable of `Sample`s (the reference's
        RDD[Sample] ingest path, cached like
        `CachedDistributedFeatureSet`)."""
        feats: "list[list[np.ndarray]]" = []
        labels: "list[list[np.ndarray]]" = []
        has_label = None
        multi_label = False
        for s in samples:
            arrays = s.feature_arrays()
            if not feats:
                feats = [[] for _ in arrays]
            for col, a in zip(feats, arrays):
                col.append(a)
            if has_label is None:
                has_label = s.label is not None
                multi_label = isinstance(s.label, (list, tuple))
                if has_label:
                    labels = [[] for _ in
                              (s.label if multi_label else [s.label])]
            if has_label:
                lab = s.label if multi_label else [s.label]
                for col, a in zip(labels, lab):
                    col.append(np.asarray(a))
        if not feats:
            raise ValueError("empty sample stream")
        x_cols = [_stack_column(c) for c in feats]
        if not has_label:
            y_col = None
        elif multi_label:
            # keep multi-output label columns separate (a bare
            # np.asarray over the pairs would silently stack
            # same-shaped outputs into one bogus column)
            y_col = [_stack_column(c) for c in labels]
        else:
            y_col = _stack_column(labels[0])
        return FeatureSet(x_cols, y_col, memory_type=memory_type, **kw)

    @staticmethod
    def from_rdd(rdd: Any,
                 preprocessing: Optional[Preprocessing] = None,
                 memory_type="dram",
                 shard_index: Optional[int] = None,
                 num_shards: Optional[int] = None, **kw) -> "FeatureSet":
        """Ingest from anything implementing the RDD protocol: a real
        ``pyspark.RDD`` or :class:`~analytics_zoo_tpu_torch.feature.rdd.
        LocalRdd` (the Scala ``FeatureSet.rdd``,
        ``Z/feature/FeatureSet.scala:308``).

        Each process collects only its round-robin share of the
        partitions (by default ``torch.distributed``'s rank and world
        size, :func:`~analytics_zoo_tpu_torch.feature.rdd.
        process_shard_spec`), so ingest over several processes needs no
        flags. Records may be ``Sample`` s, ``(feature, label)`` tuples,
        bare features, or raw values run through ``preprocessing``.
        """
        from analytics_zoo_tpu_torch.feature.rdd import (collect_shard,
                                                         is_spark_dataframe)
        if is_spark_dataframe(rdd):
            rdd = rdd.rdd
        records = collect_shard(rdd, shard_index, num_shards)
        if records and not isinstance(records[0], Sample) \
                and preprocessing is None:
            # raw (feature, label) tuples or bare feature arrays
            records = [Sample(feature=r[0], label=r[1])
                       if isinstance(r, tuple) and len(r) == 2
                       else Sample(feature=r) for r in records]
        # the shard filter already ran; the row-range splitter must not
        # re-shard what is now purely local data
        return FeatureSet.from_iterable(
            records, preprocessing, memory_type=memory_type,
            shard_index=0, num_shards=1, **kw)

    @staticmethod
    def from_iterable(records: Iterable[Any],
                      preprocessing: Optional[Preprocessing] = None,
                      memory_type="dram", **kw) -> "FeatureSet":
        stream: Iterable[Any] = records
        if preprocessing is not None:
            stream = preprocessing.transform(stream)
        return FeatureSet.sample_rdd(stream, memory_type=memory_type, **kw)

    # -- transforms ---------------------------------------------------------
    def transform(self, preprocessing: Preprocessing) -> "FeatureSet":
        """Apply a Preprocessing chain, re-caching the result (reference
        `FeatureSet.transform` returning a transformed cached set)."""
        return FeatureSet.from_iterable(
            self._iter_samples(), preprocessing,
            memory_type=self.memory_type.value)

    def _iter_samples(self) -> Iterator[Sample]:
        for i in range(self._n):
            feats = [c[i] for c in self._x]
            if not self._y_cols:
                label = None
            elif self._multi_y:
                label = [c[i] for c in self._y_cols]
            else:
                label = self._y_cols[0][i]
            yield Sample(feature=feats if len(feats) > 1 else feats[0],
                         label=label)

    # -- Estimator data protocol -------------------------------------------
    @property
    def num_samples(self) -> int:
        return self._n

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True
                     ) -> Iterator[Tuple[Any, Any]]:
        """Per-epoch index permutation (the reference's reshuffle via
        shuffled index array, `FeatureSet.scala:216-296`)."""
        idx = np.arange(self._n)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        end = (self._n - self._n % batch_size) if drop_last else self._n
        for start in range(0, end, batch_size):
            sel = np.sort(idx[start:start + batch_size]) if \
                self.memory_type == MemoryType.PMEM else \
                idx[start:start + batch_size]
            xb = [np.asarray(c[sel]) for c in self._x]
            xb = xb[0] if len(xb) == 1 else xb
            if not self._y_cols:
                yb = None
            elif self._multi_y:
                yb = [np.asarray(c[sel]) for c in self._y_cols]
            else:
                yb = np.asarray(self._y_cols[0][sel])
            yield xb, yb

    def __len__(self):
        return self._n

    def __repr__(self):
        return (f"FeatureSet(n={self._n}, tier={self.memory_type.value}, "
                f"x_cols={len(self._x)}, "
                f"labeled={self._y is not None})")
