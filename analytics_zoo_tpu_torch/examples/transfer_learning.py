"""Transfer-learning example: take a pretrained-style backbone, cut its
graph at a feature node (``new_graph``), freeze everything up to it
(``freeze_up_to``), attach a fresh 2-class head and fine-tune only the
head. BASELINE's second configuration is dogs-vs-cats transfer learning.

With no ``--weights`` it first trains the backbone briefly on a
synthetic 10-class task, standing in for published weights; pass
``--weights`` to start from a ``save_weights`` file of the backbone.

    python -m analytics_zoo_tpu_torch.examples transfer_learning
    python -m analytics_zoo_tpu_torch.examples transfer_learning \\
        --device cpu --n 64
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", default=None)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--n", type=int, default=128)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Input
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        Convolution2D, Dense, GlobalAveragePooling2D, MaxPooling2D)
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model

    init_nncontext(device=args.device)
    size = args.image_size
    rs = np.random.RandomState(0)

    # a backbone graph with named nodes (the published model's stand-in)
    inp = Input((size, size, 3), name="image")
    c1 = Convolution2D(8, 3, border_mode="same", activation="relu",
                       name="conv1")(inp)
    p1 = MaxPooling2D(name="pool1")(c1)
    c2 = Convolution2D(16, 3, border_mode="same", activation="relu",
                       name="conv2")(p1)
    feat = GlobalAveragePooling2D(name="features")(c2)
    old_head = Dense(10, activation="softmax", name="old_head")(feat)
    backbone = Model(inp, old_head, name="backbone")
    backbone.compile(optimizer="adam",
                     loss="sparse_categorical_crossentropy")
    if args.weights:
        backbone.load_weights(args.weights)
    else:  # brief pretraining on a 10-class synthetic task
        x0 = rs.rand(args.n, size, size, 3).astype(np.float32)
        y0 = rs.randint(0, 10, (args.n, 1)).astype(np.int32)
        backbone.fit(x0, y0, batch_size=32, nb_epoch=1)

    # the transfer-learning surgery
    trunk = backbone.new_graph(["features"])
    trunk.freeze_up_to("features")
    new_out = Dense(2, activation="softmax", name="cats_dogs")(
        trunk.outputs[0])
    tuned = Model(trunk.inputs, new_out, name="tuned")
    tuned.compile(optimizer="adam",
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    tuned.copy_weights_from(backbone)  # by layer name

    # separable synthetic cats-vs-dogs: the class shifts the channel mix
    y = rs.randint(0, 2, (args.n, 1)).astype(np.int32)
    x = rs.rand(args.n, size, size, 3).astype(np.float32)
    x[:, :, :, 0] += 0.8 * y.reshape(-1, 1, 1)
    before = params_to_numpy(backbone)["conv1"]["kernel"]
    tuned.fit(x, y, batch_size=32, nb_epoch=args.epochs)
    after = params_to_numpy(tuned)["conv1"]["kernel"]
    if not np.array_equal(before, after):
        raise RuntimeError("the frozen conv1 moved during fine-tuning")
    metrics = tuned.evaluate(x, y, batch_size=32)
    print(f"transfer_learning: frozen-backbone fine-tune metrics "
          f"{metrics}")
    return metrics


if __name__ == "__main__":
    main()
