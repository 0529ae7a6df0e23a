"""NNImageReader and NNImageSchema (port of
the JAX package's ``pipeline/nnframes/nn_image_reader.py``; the Scala
original is ``Z/pipeline/nnframes/NNImageReader.scala:144-182``): read
images into a pandas DataFrame whose columns are the image schema's
struct fields (origin, height, width, nChannels, mode, data). Paths
resolve through ``common.utils``' fsspec helpers, so ``gs://``,
``s3://`` and ``hdfs://`` trees read like local ones.

Pillow and pandas are imported where images are read, not at import.
"""

from __future__ import annotations

import io
import logging
from typing import List

import numpy as np

from analytics_zoo_tpu_torch.common import utils as zutils

logger = logging.getLogger(__name__)


class NNImageSchema:
    """Column names of the image struct (reference `NNImageSchema`)."""

    ORIGIN = "origin"
    HEIGHT = "height"
    WIDTH = "width"
    N_CHANNELS = "nChannels"
    MODE = "mode"
    DATA = "data"

    COLUMNS = [ORIGIN, HEIGHT, WIDTH, N_CHANNELS, MODE, DATA]

    @staticmethod
    def to_ndarray(row) -> np.ndarray:
        """An image struct row as an HWC uint8 array."""
        return np.asarray(row[NNImageSchema.DATA], np.uint8).reshape(
            int(row[NNImageSchema.HEIGHT]),
            int(row[NNImageSchema.WIDTH]),
            int(row[NNImageSchema.N_CHANNELS]))


class NNImageReader:
    @staticmethod
    def read_images(path: str, min_partitions: int = 1,
                    resize_h: int = -1, resize_w: int = -1,
                    image_codec: int = -1):
        """Every file under ``path`` (a directory, read recursively, or a
        glob) decoded to RGB, one row each; ``resize_h``/``resize_w``
        resize with PIL's bilinear filter. A file that fails to decode is
        dropped, with one warning for all of them. ``min_partitions`` and
        ``image_codec`` are kept for the reference's signature."""
        import pandas as pd
        from PIL import Image
        del min_partitions, image_codec
        files = (zutils.walk_files(path) if zutils.is_dir(path)
                 else zutils.list_files(path))
        # one batched fetch for remote schemes; an IO error propagates,
        # only a decode failure marks a file as not an image
        blobs = zutils.read_bytes_many(files)

        def decode(f):
            try:
                with Image.open(io.BytesIO(blobs[f])) as im:
                    rgb = im.convert("RGB")
                    if resize_h > 0 and resize_w > 0:
                        rgb = rgb.resize((resize_w, resize_h),
                                         Image.BILINEAR)
                    return np.asarray(rgb, np.uint8)
            except Exception:
                return None

        rows = []
        dropped: List[str] = []
        # PIL's decode and resize release the GIL: a thread pool (the
        # knob of ImageSet.read's decoder)
        for f, arr in zip(files, zutils.parallel_map(decode, files)):
            if arr is None:
                dropped.append(f)
                continue
            rows.append({
                NNImageSchema.ORIGIN: f,
                NNImageSchema.HEIGHT: arr.shape[0],
                NNImageSchema.WIDTH: arr.shape[1],
                NNImageSchema.N_CHANNELS: arr.shape[2],
                NNImageSchema.MODE: 16,  # OpenCV's CV_8UC3, as Spark's
                NNImageSchema.DATA: arr.reshape(-1),
            })
        if dropped:
            logger.warning(
                "NNImageReader: skipped %d of %d file(s) that failed "
                "to decode (first: %s)", len(dropped), len(files),
                dropped[0])
        return pd.DataFrame(rows, columns=NNImageSchema.COLUMNS)
