"""The Spark RDD/DataFrame ingest adapter (port of
``analytics_zoo_tpu/feature/rdd.py``, kept as a
copy; the Scala original feeds ``RDD[Sample]`` to ``FeatureSet.rdd``,
``Z/feature/FeatureSet.scala:308-335``, and to ``KerasNet.fit``).

Spark is an ingest role, not a dependency. Anything with
``getNumPartitions()``, ``mapPartitionsWithIndex(f)`` and ``collect()``
can feed a :class:`~analytics_zoo_tpu_torch.feature.feature_set.
FeatureSet`: a real ``pyspark.RDD`` (nothing here imports pyspark; the
closures shipped to executors use the standard library only), or
:class:`LocalRdd`, the in-process implementation that tests and
Spark-less deployments use.

Several processes: each keeps the partitions ``p % world_size ==
rank`` (round robin over partitions), ``rank`` and ``world_size`` those
of ``torch.distributed``'s process group when one is initialised.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, Optional


from analytics_zoo_tpu_torch.common.nncontext import logger


def process_shard_spec() -> "tuple[int, int]":
    """(shard_index, num_shards) for this process: ``torch.distributed``'s
    (rank, world size) when a process group is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_rdd_like(obj: Any) -> bool:
    """The duck-typed RDD protocol."""
    return all(hasattr(obj, m) for m in
               ("mapPartitionsWithIndex", "collect", "getNumPartitions"))


def is_spark_dataframe(obj: Any) -> bool:
    """A pyspark DataFrame quacks: has .rdd, .columns and .toPandas but
    is not a pandas DataFrame (pandas has no .rdd)."""
    return hasattr(obj, "rdd") and hasattr(obj, "toPandas") \
        and hasattr(obj, "columns")


def _partition_filter(shard_index: int, num_shards: int) -> Callable:
    """Closure shipped to executors: keep round-robin-owned partitions.

    Stdlib-only on purpose — a real pyspark executor pickles this and
    must not need this package installed on the cluster."""

    def keep(pid, it):
        return it if pid % num_shards == shard_index else iter(())

    return keep


def iter_shard(rdd: Any, shard_index: Optional[int] = None,
               num_shards: Optional[int] = None) -> Iterator:
    """Stream this process's round-robin share of an RDD-like's records.

    Uses ``toLocalIterator()`` when the RDD provides it (pyspark does:
    one partition resident at a time in the Spark application's main
    process; the Scala ``NNEstimator.scala:571-674`` streams partitions
    through executors the same way) and falls back to ``collect()``
    otherwise."""
    if shard_index is None or num_shards is None:
        shard_index, num_shards = process_shard_spec()
    if num_shards == 1:
        owned = rdd
    else:
        n_parts = rdd.getNumPartitions()
        if n_parts < num_shards:
            logger.warning(
                "RDD has %d partitions < %d ingest hosts; repartition "
                "the RDD for balanced multi-host ingest", n_parts,
                num_shards)
        owned = rdd.mapPartitionsWithIndex(
            _partition_filter(shard_index, num_shards))
    tli = getattr(owned, "toLocalIterator", None)
    src = tli() if callable(tli) else owned.collect()
    # the record count in this process (the executor-shipped closures above
    # stay stdlib-only); ONE chunked increment per stream, no lock in
    # the per-record path
    n = 0
    try:
        for rec in src:
            n += 1
            yield rec
    finally:
        from analytics_zoo_tpu_torch.common.observability import counter
        if n:
            counter("zoo_tpu_ingest_records_total",
                    help="records emitted per ingest stage",
                    labels={"stage": "rdd"}).inc(n)


def collect_shard(rdd: Any, shard_index: Optional[int] = None,
                  num_shards: Optional[int] = None) -> "list":
    """Collect this host's round-robin share of an RDD-like's records
    (materialised; prefer :func:`iter_shard` for streaming)."""
    return list(iter_shard(rdd, shard_index, num_shards))


class LocalRdd:
    """In-process reference implementation of the RDD ingest protocol.

    Plays the role pyspark's RDD plays in the reference, for tests and
    Spark-less deployments; the FeatureSet/nnframes ingest code treats
    it and a real ``pyspark.RDD`` identically.
    """

    def __init__(self, records: Iterable[Any], num_partitions: int = 4):
        records = list(records)
        self._parts: "list[list]" = [[] for _ in range(num_partitions)]
        if records:
            # contiguous split, like sc.parallelize
            n = len(records)
            k = num_partitions
            lo = 0
            for i in range(k):
                hi = lo + n // k + (1 if i < n % k else 0)
                self._parts[i] = records[lo:hi]
                lo = hi

    @staticmethod
    def of_partitions(parts: "list[list]") -> "LocalRdd":
        r = LocalRdd([], num_partitions=len(parts))
        r._parts = [list(p) for p in parts]
        return r

    def getNumPartitions(self) -> int:
        return len(self._parts)

    def mapPartitionsWithIndex(self, f) -> "LocalRdd":
        return LocalRdd.of_partitions(
            [list(f(i, iter(p))) for i, p in enumerate(self._parts)])

    def mapPartitions(self, f) -> "LocalRdd":
        return self.mapPartitionsWithIndex(lambda i, it: f(it))

    def map(self, f) -> "LocalRdd":
        return self.mapPartitionsWithIndex(
            lambda i, it: (f(x) for x in it))

    def filter(self, f) -> "LocalRdd":
        return self.mapPartitionsWithIndex(
            lambda i, it: (x for x in it if f(x)))

    def repartition(self, n: int) -> "LocalRdd":
        return LocalRdd(self.collect(), num_partitions=n)

    def collect(self) -> "list":
        return list(itertools.chain.from_iterable(self._parts))

    def toLocalIterator(self) -> Iterator:
        """Stream records one partition at a time (pyspark parity);
        `partitions_fetched` counts entered partitions so tests can
        assert laziness."""
        for p in self._parts:
            self.partitions_fetched = getattr(
                self, "partitions_fetched", 0) + 1
            yield from p

    def count(self) -> int:
        return sum(len(p) for p in self._parts)
