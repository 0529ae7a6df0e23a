"""nnframes classification example: a Spark-ML-style ``NNClassifier``
over a pandas DataFrame; ``fit`` returns an ``NNClassifierModel``
transformer that appends a prediction column (the reference's
``pyzoo/zoo/examples/nnframes`` examples).

Class ids are 0-based, as the losses and the argmax are.

    python -m analytics_zoo_tpu_torch.examples nnframes_classification
    python -m analytics_zoo_tpu_torch.examples nnframes_classification \\
        --device cpu --samples 64
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    import pandas as pd

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.feature.common import SeqToTensor
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    feats = rng.randn(args.samples, 6).astype(np.float32)
    labels = (feats.sum(axis=1) > 0).astype(np.int64)
    df = pd.DataFrame({"features": list(feats), "label": labels})

    net = Sequential()
    net.add(L.Dense(16, input_shape=(6,), activation="relu"))
    net.add(L.Dense(2, activation="softmax"))

    clf = (NNClassifier(net, "sparse_categorical_crossentropy",
                        SeqToTensor((6,)))
           .set_batch_size(32)
           .set_max_epoch(args.epochs)
           .set_learning_rate(0.05)
           .set_optim_method("adam"))
    model = clf.fit(df)
    out = model.transform(df)
    acc = float((out["prediction"] == out["label"]).mean())
    print(f"train accuracy: {acc:.3f}")
    return acc


if __name__ == "__main__":
    main()
