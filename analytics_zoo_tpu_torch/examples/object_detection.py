"""SSD object-detection inference example: load an SSD detector, run
batched detection, print boxes. Random weights and synthetic images by
default (no pretrained-model download); point ``--weights`` at a saved
weight file for real detections.

    python -m analytics_zoo_tpu_torch.examples object_detection
    python -m analytics_zoo_tpu_torch.examples object_detection --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="ssd-vgg16-300x300")
    p.add_argument("--weights", default=None,
                   help="optional .npz weight file (save_weights)")
    p.add_argument("--images", type=int, default=2)
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        ObjectDetector,
    )

    init_nncontext(device=args.device)
    detector = ObjectDetector(args.model)
    if args.weights:
        detector.model.load_weights(args.weights)
    else:
        detector.compile()  # random weights: demonstrates the pipeline

    rng = np.random.RandomState(0)
    size = detector.img_size
    images = rng.rand(args.images, size, size, 3).astype(np.float32)
    results = detector.detect(images, batch_size=args.images,
                              conf_threshold=args.conf)
    for i, dets in enumerate(results):
        print(f"image {i}: {len(dets)} detections")
        for d in dets[:5]:
            print(f"  class={d.class_id} score={d.score:.3f} "
                  f"box={np.round(d.box, 3).tolist()}")
    return results


if __name__ == "__main__":
    main()
