"""LeNet-5 training example: command-line options, the context, the
model, ``fit`` with validation, then ``evaluate``. BASELINE's first
configuration (LeNet-5 on MNIST through the Keras API).

It trains on random MNIST-shaped data unless ``--data-dir`` holds an
``mnist.npz`` (keys ``x_train``, ``y_train``, ``x_test``, ``y_test``),
as the JAX package's example does.

    python -m analytics_zoo_tpu_torch.examples lenet_mnist
    python -m analytics_zoo_tpu_torch.examples lenet_mnist --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_data(data_dir, n_train, n_test, rng):
    if data_dir and os.path.exists(os.path.join(data_dir, "mnist.npz")):
        with np.load(os.path.join(data_dir, "mnist.npz")) as d:
            return (d["x_train"][..., None] / 255.0,
                    d["y_train"].reshape(-1, 1),
                    d["x_test"][..., None] / 255.0,
                    d["y_test"].reshape(-1, 1))
    x_train = rng.rand(n_train, 28, 28, 1).astype(np.float32)
    y_train = rng.randint(0, 10, (n_train, 1)).astype(np.int32)
    x_test = rng.rand(n_test, 28, 28, 1).astype(np.float32)
    y_test = rng.randint(0, 10, (n_test, 1)).astype(np.int32)
    return x_train, y_train, x_test, y_test


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-dir", default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-test", type=int, default=128)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        lenet5
    from analytics_zoo_tpu_torch.ops.optimizers import SGD

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    x_train, y_train, x_test, y_test = load_data(
        args.data_dir, args.n_train, args.n_test, rng)

    model = lenet5(input_shape=x_train.shape[1:], classes=10)
    model.compile(optimizer=SGD(lr=args.lr, momentum=0.9),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x_train.astype(np.float32), y_train,
              batch_size=args.batch_size, nb_epoch=args.epochs,
              validation_data=(x_test.astype(np.float32), y_test))
    metrics = model.evaluate(x_test.astype(np.float32), y_test,
                             batch_size=args.batch_size)
    print(f"test metrics: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
