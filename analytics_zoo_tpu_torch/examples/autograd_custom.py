"""Custom-loss autograd example (the reference's
``P/examples/autograd/customloss.py`` and ``custom.py``): fit y = 2·x₁ +
2·x₂ + 0.4 with a Dense(1) under a mean-absolute-error loss written with
the autograd operators, then read the weights back.

    python -m analytics_zoo_tpu_torch.examples autograd_custom
    python -m analytics_zoo_tpu_torch.examples autograd_custom --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np


def mean_absolute_error(y_true, y_pred):
    from analytics_zoo_tpu_torch.pipeline.api import autograd as A
    return A.mean(A.abs(y_true - y_pred), axis=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api.autograd import CustomLoss
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import (
        Sequential, to_numpy)

    init_nncontext(device=args.device)
    rs = np.random.RandomState(0)
    x = rs.uniform(0, 1, (args.n, 2)).astype(np.float32)
    y = ((2 * x).sum(1) + 0.4).reshape(args.n, 1).astype(np.float32)

    model = Sequential()
    model.add(L.Dense(1, input_shape=(2,)))
    model.compile(optimizer=SGD(lr=1e-1),
                  loss=CustomLoss(mean_absolute_error, y_pred_shape=(1,)))
    model.fit(x, y, batch_size=32, nb_epoch=args.epochs)
    pred = model.predict(x)
    mae = float(np.mean(np.abs(pred - y)))
    # the Dense's kernel (get_weights' sorted order puts its bias first)
    kernel = to_numpy(model.layers[0].params()["kernel"]).reshape(-1)
    print(f"learned weights ~ [2, 2]: {kernel.round(2)}  mae={mae:.4f}")
    return {"mae": mae, "weights": kernel}


if __name__ == "__main__":
    main()
