"""Image-classification predict example: load an ImageClassifier by
architecture name (optionally with a weights file), read an image
folder into an ImageSet through the host transforms, and print the
top-N classes per image.

Without ``--folder`` it predicts on four seeded random images; point
``--folder``/``--weights`` at real data for real predictions. Decoding
and resizing a folder need PIL.

    python -m analytics_zoo_tpu_torch.examples image_classification
    python -m analytics_zoo_tpu_torch.examples image_classification \\
        --folder photos/ --model squeezenet --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--folder", default=None,
                   help="directory of images (jpg/png)")
    p.add_argument("--model", default="mobilenet-v2",
                   help="architecture name or save_model path")
    p.add_argument("--weights", default=None)
    p.add_argument("--top-n", type=int, default=3)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--classes", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.feature.image import (ImageMatToFloats,
                                                       ImageResize, ImageSet)
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier

    init_nncontext(device=args.device)
    size = args.image_size
    # random weights only when no weight source is configured at all: a
    # configured pretrained directory that does not resolve raises
    imc = ImageClassifier.load_model(
        args.model, weights_path=args.weights,
        input_shape=(size, size, 3), classes=args.classes,
        allow_random=(args.weights is None
                      and not os.environ.get("ZOO_TPU_PRETRAINED_DIR")))
    if args.weights is None:
        imc.compile()

    if args.folder:
        image_set = ImageSet.read(args.folder).transform(
            ImageResize(size, size), ImageMatToFloats())
        x = np.stack([f.image for f in image_set.features]).reshape(
            -1, size, size, 3)
        uris = [f[f.URI] for f in image_set.features]
    else:
        rs = np.random.RandomState(0)
        x = rs.rand(4, size, size, 3).astype(np.float32)
        uris = [f"synthetic_{i}" for i in range(len(x))]

    probs = imc.predict(x, batch_size=len(x))
    results = []
    for uri, row in zip(uris, probs):
        top = np.argsort(row)[::-1][:args.top_n]
        results.append((uri, [(int(c), float(row[c])) for c in top]))
        pretty = ", ".join(f"class {c}: {q:.3f}" for c, q in results[-1][1])
        print(f"{uri}: {pretty}")
    return results


if __name__ == "__main__":
    main()
