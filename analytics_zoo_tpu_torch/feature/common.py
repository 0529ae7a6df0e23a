"""Preprocessing algebra and the Sample container (port of
``analytics_zoo_tpu/feature/common.py``, pure Python and numpy, kept as
a copy): composable ``Preprocessing`` stages chained with ``>>``, and
the adapters (``ArrayToTensor``, ``SeqToTensor``, ``ScalarToTensor``,
``TensorToSample``, ``FeatureLabelPreprocessing``) that turn records
into training ``Sample`` s. The "tensors" are numpy arrays: the
Estimator places batches on the device.

    pre = SeqToTensor((3,)) >> TensorToSample()
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


@dataclass
class Sample:
    """A (features, label) record — the BigDL `Sample` analog. Features
    may be a single ndarray or a list (multi-input models)."""

    feature: Any
    label: Optional[Any] = None

    def feature_arrays(self) -> "list[np.ndarray]":
        f = self.feature
        return [np.asarray(a) for a in (f if isinstance(f, (list, tuple))
                                        else [f])]


def _count_ingest(stage: str, records: int, nbytes: int = 0):
    """Per-stage ingest counters on the port's metrics registry. One
    increment per stream, not per record: the counters put no lock
    acquisition in the per-record path."""
    from analytics_zoo_tpu_torch.common.observability import counter
    if records:
        counter("zoo_tpu_ingest_records_total",
                help="records emitted per ingest stage",
                labels={"stage": stage}).inc(records)
    if nbytes:
        counter("zoo_tpu_ingest_bytes_total",
                help="bytes ingested per ingest stage",
                labels={"stage": stage}).inc(nbytes)


class Preprocessing:
    """Composable transformer; subclass and implement
    :meth:`apply` (single record) or override :meth:`transform`
    (stream)."""

    def apply(self, record: Any) -> Any:
        raise NotImplementedError

    def transform(self, records: Iterable[Any]) -> Iterator[Any]:
        n = 0
        try:
            for r in records:
                out = self.apply(r)
                if out is not None:
                    n += 1
                    yield out
        finally:
            _count_ingest(type(self).__name__, n)

    def __rshift__(self, other: "Preprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])

    def __call__(self, records: Iterable[Any]) -> Iterator[Any]:
        return self.transform(records)


class ChainedPreprocessing(Preprocessing):
    """(reference `ChainedPreprocessing`)"""

    def __init__(self, stages: Sequence[Preprocessing]):
        self.stages = []
        for s in stages:
            if isinstance(s, ChainedPreprocessing):
                self.stages.extend(s.stages)
            else:
                self.stages.append(s)

    def apply(self, record: Any) -> Any:
        for s in self.stages:
            record = s.apply(record)
            if record is None:
                return None
        return record

    def transform(self, records: Iterable[Any]) -> Iterator[Any]:
        for s in self.stages:
            records = s.transform(records)
        return iter(records)


class FnPreprocessing(Preprocessing):
    """Lift a plain function."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def apply(self, record):
        return self.fn(record)


class ArrayToTensor(Preprocessing):
    """ndarray-like → float32 ndarray with declared shape (reference
    `ArrayToTensor`)."""

    def __init__(self, size: Optional[Sequence[int]] = None):
        self.size = None if size is None else tuple(size)

    def apply(self, record):
        arr = np.asarray(record, np.float32)
        if self.size is not None:
            arr = arr.reshape(self.size)
        return arr


class SeqToTensor(ArrayToTensor):
    """sequence of numbers → tensor (reference `SeqToTensor`)."""


class ScalarToTensor(Preprocessing):
    """scalar → 1-element tensor (reference `ScalarToTensor`)."""

    def apply(self, record):
        return np.asarray([record], np.float32)


class MLlibVectorToTensor(ArrayToTensor):
    """dense-vector-like → tensor (reference `MLlibVectorToTensor`;
    accepts anything with `.toArray()` or array-like)."""

    def apply(self, record):
        if hasattr(record, "toArray"):
            record = record.toArray()
        return super().apply(record)


class TensorToSample(Preprocessing):
    """tensor → Sample(feature) (reference `TensorToSample`)."""

    def apply(self, record):
        return Sample(feature=record)


class FeatureLabelPreprocessing(Preprocessing):
    """(feature, label) tuple → Sample, with per-side preprocessing
    (reference `FeatureLabelPreprocessing`)."""

    def __init__(self, feature_preprocessing: Preprocessing,
                 label_preprocessing: Optional[Preprocessing] = None):
        self.feature_pre = feature_preprocessing
        self.label_pre = label_preprocessing

    def apply(self, record):
        feature, label = record
        f = self.feature_pre.apply(feature)
        l = label
        if label is not None and self.label_pre is not None:
            l = self.label_pre.apply(label)
        return Sample(feature=f, label=l)


class BigDLAdapter(FnPreprocessing):
    """Kept for API parity: lifts any unary callable (the reference lifts
    BigDL `Transformer`s)."""
