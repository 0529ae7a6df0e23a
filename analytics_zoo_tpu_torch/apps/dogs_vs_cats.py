"""Dogs-vs-cats transfer learning (the reference's ``apps/dogs-vs-cats``,
BASELINE's second configuration, "nnframes NNClassifier: dogs-vs-cats
Inception-v1 transfer learning"): a cat/dog image folder read with
``ImageSet.read(with_label_from_dirs=True)``, an ``ImageClassifier``
backbone with every layer but the head frozen, then ``NNClassifier``'s
``fit`` and ``transform`` over a DataFrame.

Without ``--folder`` a synthetic folder is written (Pillow); with
``--in-memory`` the same synthetic images stay arrays and no image file
is written or decoded (a machine without Pillow). The default backbone
is the shallow lenet-5, as in the reference app: a deep backbone's random
features carry little; ``--arch inception-v1 --image-size 224`` is the
reference's configuration (with ``--weights`` for real transfer).

    python -m analytics_zoo_tpu_torch.apps dogs_vs_cats
    python -m analytics_zoo_tpu_torch.apps dogs_vs_cats --device cpu \\
        --per-class 16 --epochs 10 --batch-size 16
    python -m analytics_zoo_tpu_torch.apps dogs_vs_cats --in-memory \\
        --arch inception-v1 --image-size 224 --epochs 2
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

CLASSES = (("cat", 0, 128), ("dog", 128, 255))


def synth_images(per_class: int, size: int, rng):
    """``(images, labels)``: uint8 HWC images whose classes differ in
    brightness, so that a frozen random backbone and a linear head can
    still learn offline."""
    images, labels = [], []
    for label, (_, lo, hi) in enumerate(CLASSES):
        for _ in range(per_class):
            images.append(rng.randint(lo, hi, (size, size, 3))
                          .astype(np.uint8))
            labels.append(label)
    return images, labels


def synth_folder(root: str, per_class: int, size: int, rng) -> None:
    """The synthetic images as ``cat/<i>.png`` and ``dog/<i>.png``."""
    from PIL import Image
    images, labels = synth_images(per_class, size, rng)
    for i, (img, label) in enumerate(zip(images, labels)):
        d = os.path.join(root, CLASSES[label][0])
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img).save(os.path.join(d, f"{i % per_class}.png"))


def frozen_leaves(net) -> dict:
    """The trainable leaves of the frozen layers (BatchNormalization's
    moving statistics, which follow the batches, left out)."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy

    def drop_state(tree):
        return {k: drop_state(v) if isinstance(v, dict) else v
                for k, v in tree.items() if k != "_state"}
    return {lyr.name: drop_state(params_to_numpy(lyr.params()))
            for lyr in net.layers if not lyr.trainable and lyr.params()}


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", default=None,
                   help="cat/... dog/... image folder (local or an "
                        "fsspec scheme); omit for synthetic data")
    p.add_argument("--in-memory", action="store_true",
                   help="synthetic images as arrays: no folder, no "
                        "Pillow")
    p.add_argument("--arch", default="lenet-5",
                   help="the backbone (ImageClassifier.ARCHS); the "
                        "reference app uses inception-v1 with pretrained "
                        "weights (--weights)")
    p.add_argument("--weights", default=None,
                   help="backbone weights (.npz) for real transfer "
                        "learning")
    p.add_argument("--image-size", type=int, default=28)
    p.add_argument("--per-class", type=int, default=32)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    import pandas as pd

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.feature.common import SeqToTensor
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier

    init_nncontext(device=args.device)
    rng = np.random.RandomState(0)
    size = args.image_size
    channels = 1 if args.arch == "lenet-5" else 3

    # 1. images and labels from the class-folder layout
    if args.in_memory:
        images, labels = synth_images(args.per_class, size, rng)
    else:
        from analytics_zoo_tpu_torch.feature.image import (ImageResize,
                                                           ImageSet)
        folder = args.folder
        if folder is None:
            folder = tempfile.mkdtemp(prefix="dogs_cats_")
            synth_folder(folder, args.per_class, size, rng)
        iset = ImageSet.read(folder, with_label_from_dirs=True) \
            .transform(ImageResize(size, size))
        images = [f.image for f in iset.features]
        labels = [int(f.label[0]) for f in iset.features]
    feats = []
    for img in images:
        arr = np.asarray(img, np.float32) / 255.0
        if channels == 1:
            arr = arr.mean(axis=-1, keepdims=True)
        feats.append(arr)
    df = pd.DataFrame({"features": feats,
                       "label": np.asarray(labels, np.float64)})

    # 2. the backbone, every layer but the classification head frozen
    # (the reference's freezeUpTo)
    backbone = ImageClassifier(args.arch, input_shape=(size, size, channels),
                               classes=2)
    backbone.model.compile()
    if args.weights:
        backbone.model.load_weights(args.weights)
    net = backbone.model
    if not net.initialized:
        net.init_params()
    net.freeze(*[lyr.name for lyr in net.layers[:-1]])
    n_frozen = sum(1 for lyr in net.layers if not lyr.trainable)
    print(f"backbone {args.arch}: {len(net.layers)} layers, {n_frozen} "
          "frozen, the head trains")
    frozen_before = frozen_leaves(net)

    # 3. Spark-ML-style training and scoring. lenet-5 ends in softmax
    # (a probability-space loss), the other backbones in logits
    loss = ("sparse_categorical_crossentropy" if args.arch == "lenet-5"
            else "softmax_cross_entropy")
    clf = (NNClassifier(net, loss, SeqToTensor((size, size, channels)))
           .set_batch_size(args.batch_size).set_max_epoch(args.epochs)
           .set_optim_method(Adam(lr=1e-2)))
    t0 = time.perf_counter()
    model = clf.fit(df)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = model.transform(df)
    transform_s = time.perf_counter() - t0
    acc = float((out["prediction"] == out["label"]).mean())
    frozen_kept = same_tree(frozen_before, frozen_leaves(net))
    print(f"train accuracy: {acc:.3f} over {len(df)} images; fit "
          f"{fit_s:.2f} s, transform {transform_s:.2f} s; frozen layers "
          f"unchanged: {frozen_kept}")
    return {"accuracy": acc, "images": len(df), "fit_s": fit_s,
            "transform_s": transform_s, "frozen_unchanged": frozen_kept,
            "epochs": args.epochs}


if __name__ == "__main__":
    main()
