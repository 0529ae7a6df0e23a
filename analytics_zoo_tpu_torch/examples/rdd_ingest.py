"""RDD ingest example: records of an RDD-like collection (here a
``LocalRdd``; a ``pyspark`` RDD from ``sc.parallelize`` works the same)
collected into a ``FeatureSet``, then trained on and evaluated.

Each process keeps its round-robin share of the partitions
(``torch.distributed``'s rank and world size when a process group is
initialised).

    python -m analytics_zoo_tpu_torch.examples rdd_ingest
    python -m analytics_zoo_tpu_torch.examples rdd_ingest --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--partitions", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.feature import FeatureSet, LocalRdd, Sample
    from analytics_zoo_tpu_torch.pipeline.api.keras import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    init_nncontext(device=args.device)
    rs = np.random.RandomState(0)
    w_true = rs.randn(8, 3).astype(np.float32)
    records = []
    for _ in range(args.n):
        x = rs.randn(8).astype(np.float32)
        y = int(np.argmax(x @ w_true))
        records.append(Sample(feature=x, label=np.array([y], np.int32)))

    # anything with mapPartitionsWithIndex/collect/getNumPartitions
    # works here, e.g. sc.parallelize(records, 8)
    rdd = LocalRdd(records, num_partitions=args.partitions)
    fs = FeatureSet.from_rdd(rdd)
    print(f"ingested: {fs}")

    model = Sequential()
    model.add(L.Dense(16, activation="relu", input_shape=(8,)))
    model.add(L.Dense(3))
    model.compile(optimizer="adam", loss="softmax_cross_entropy",
                  metrics=["accuracy"])
    model.fit(fs, batch_size=args.batch_size, nb_epoch=args.epochs)
    metrics = model.evaluate(fs, batch_size=args.batch_size)
    print("metrics:", metrics)
    return metrics


if __name__ == "__main__":
    main()
