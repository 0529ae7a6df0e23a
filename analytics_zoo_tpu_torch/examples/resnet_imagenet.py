"""ImageNet-style ResNet-50 training recipe, the reference's Inception
ImageNet example (``Z/examples/inception/Train.scala:70-107``: SGD with
warmup and poly decay, a checkpoint every epoch) on the card:

- data: an image folder through ``ImageSet.read`` (decoded on a thread
  pool, one host resize to 1.15x the crop) or seeded synthetic images;
- augmentation on the card inside the train step
  (``feature/image/device_transforms``): Inception's random resized
  crop, a horizontal flip, brightness and saturation jitter, ImageNet's
  normalisation;
- model: ``resnet50(space_to_depth=..., fused=...)``, whose fused
  bottlenecks run the hand-written conv+BN kernels;
- training: the Estimator with SGD momentum 0.9 on a warmup-then-poly
  schedule, epoch checkpoints (written in the background under
  ``ZOO_TPU_ASYNC_CKPT=1``), bf16 activations under
  ``ZOO_TPU_DTYPE_POLICY=mixed_bfloat16``.

Demo sizes by default; ``--image-size 224 --batch-per-device 128
--classes 1000`` is the real recipe's width. It trains on one card;
``--devices`` other than 0 or 1 waits for data parallelism (ROADMAP
A14).

    python -m analytics_zoo_tpu_torch.examples resnet_imagenet
    python -m analytics_zoo_tpu_torch.examples resnet_imagenet --device cpu \\
        --image-size 32 --batch-per-device 2 --fused 0
"""

from __future__ import annotations

import argparse

import numpy as np

IMAGENET_MEAN = (123.68, 116.779, 103.939)
IMAGENET_STD = (58.393, 57.12, 57.375)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", default=None,
                   help="class_name/xxx.jpg image tree; synthetic data "
                        "when omitted")
    p.add_argument("--devices", type=int, default=0,
                   help="cards to train on: 0 or 1 (one card)")
    p.add_argument("--image-size", type=int, default=64,
                   help="train crop size (224 for the real recipe)")
    p.add_argument("--batch-per-device", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--fused", default="auto",
                   choices=["auto", "0", "1", "defer"],
                   help="fused conv+BN bottlenecks (the CUDA kernels)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    return p.parse_args(argv)


def device_augment(size: int):
    """The recipe's augmentation on the card: crops ``size`` x ``size``
    from the ingest size."""
    from analytics_zoo_tpu_torch.feature.image import device_transforms as D
    return D.augment_pipeline(
        D.random_resized_crop((size, size), scale=(0.32, 1.0)),
        D.random_hflip(),
        D.random_brightness(32.0),
        D.random_saturation(0.3),
        D.normalize(IMAGENET_MEAN, IMAGENET_STD))


def recipe(args):
    """The recipe's data, model and Estimator: ``(est, x, y, batch)``,
    ready for ``est.train(x, y, batch_size=batch, nb_epoch=...)``."""
    if args.devices not in (0, 1):
        raise ValueError(
            f"--devices {args.devices}: the port trains on one card until "
            "its data parallelism (ROADMAP A14); pass 0 or 1")

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        resnet50
    from analytics_zoo_tpu_torch.ops.optimizers import SGD, poly, warmup
    from analytics_zoo_tpu_torch.pipeline.estimator import (Estimator,
                                                            EveryEpoch)

    ctx = init_nncontext(seed=0, device=args.device)
    s = args.image_size
    ingest = int(s * 1.15)
    batch = args.batch_per_device

    if args.folder:
        from analytics_zoo_tpu_torch.feature.image import (ImageResize,
                                                           ImageSet)
        iset = ImageSet.read(args.folder, with_label_from_dirs=True)
        # the host decodes and resizes once to the ingest size; every
        # random augmentation runs on the card
        iset = iset.transform(ImageResize(ingest, ingest))
        x, y = iset.to_arrays()       # stacked float32 NHWC, labels
        classes = int(y.max()) + 1
    else:
        rs = np.random.RandomState(0)
        n_samples = batch * 4
        x = rs.rand(n_samples, ingest, ingest, 3).astype(np.float32) * 255
        y = rs.randint(0, args.classes, size=(n_samples, 1))
        classes = args.classes
    if len(x) < batch:
        raise ValueError(f"{len(x)} samples < batch {batch}: every epoch "
                         "would run zero steps")

    fused = {"0": False, "1": True, "defer": "defer"}.get(args.fused,
                                                           "auto")
    model = resnet50(input_shape=(s, s, 3), classes=classes,
                     space_to_depth=(s % 2 == 0), fused=fused)
    steps_per_epoch = max(1, len(x) // batch)
    total_steps = steps_per_epoch * args.epochs
    warm = max(1, total_steps // 20)
    # lr / 10 up to lr over `warm` steps, then poly decay from lr
    lr = warmup(args.lr / 10, warm, delta=(args.lr * 0.9) / warm,
                after=poly(args.lr, 0.5, max(1, total_steps - warm)))
    est = Estimator(model, optimizer=SGD(lr=lr, momentum=0.9),
                    loss="sparse_categorical_crossentropy",
                    metrics=["accuracy"], ctx=ctx, augment=device_augment(s))
    if args.checkpoint:
        est.set_checkpoint(args.checkpoint, trigger=EveryEpoch())
    return est, x, y, batch


def main(argv=None):
    args = parse_args(argv)
    est, x, y, batch = recipe(args)
    res = est.train(x, y, batch_size=batch, nb_epoch=args.epochs)
    print(f"device={est.ctx.device} crop={args.image_size} batch={batch} "
          f"fused={args.fused} steps={est.step}")
    print(f"final epoch loss={res.history[-1]['loss']:.4f} "
          f"throughput={res.history[-1]['throughput']:.1f} img/s")
    return res.history


if __name__ == "__main__":
    main()
