"""ImageSet and ImageFeature (port of
``analytics_zoo_tpu/feature/image/imageset.py``, numpy on the host, kept
as a copy; the Scala original is ``Z/feature/image/ImageSet.scala:34-
229``: collections of ``ImageFeature`` read from disk or HDFS and turned
into samples).

Decoding uses PIL, imported only where an image is decoded. Pixels stay
numpy HWC uint8 until ``ImageMatToTensor`` makes them float HWC: NHWC is
the layout the port's convolutions take, so nothing is transposed on the
card.
"""

from __future__ import annotations

import io
import logging
from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.common import utils as zutils
from analytics_zoo_tpu_torch.feature.common import Preprocessing, Sample
from analytics_zoo_tpu_torch.feature.feature_set import FeatureSet

logger = logging.getLogger(__name__)


class ImageFeature(dict):
    """Mutable record for one image (reference BigDL `ImageFeature` keys:
    bytes/mat/floats/label/uri/...)."""

    IMAGE = "image"       # np.ndarray HWC (uint8 until MatToTensor)
    LABEL = "label"
    URI = "uri"
    SAMPLE = "sample"
    ORIGINAL_SIZE = "original_size"

    def __init__(self, image: Optional[np.ndarray] = None, label=None,
                 uri: Optional[str] = None):
        super().__init__()
        if image is not None:
            self[self.IMAGE] = image
            # encoded bytes (ImageBytesToMat input) have no shape yet
            if isinstance(image, np.ndarray) and image.ndim >= 2:
                self[self.ORIGINAL_SIZE] = image.shape
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    @property
    def image(self) -> np.ndarray:
        return self[self.IMAGE]

    @image.setter
    def image(self, v):
        self[self.IMAGE] = v

    @property
    def label(self):
        return self.get(self.LABEL)


def _decode(path: str) -> np.ndarray:
    """Decode one image from a local path or any fsspec scheme
    (``gs://``/``s3://``/``memory://`` — reference `ImageSet.read`
    reads straight off HDFS the same way)."""
    return _decode_bytes(zutils.read_bytes(path))


def _decode_bytes(data: bytes) -> np.ndarray:
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _decode_many(blobs, keyed) -> "list":
    """Decode `(key, extra)` pairs via ``blobs[key]``; undecodable
    files are skipped with ONE summary warning (reference: Spark's
    input machinery logs bad records rather than failing the job or
    silently shrinking the dataset).

    Decoding runs on a thread pool (``ZOO_TPU_DECODE_WORKERS``,
    default 8): PIL's decompressors release the GIL, so this plays
    the role of the reference's per-executor parallel OpenCV decode
    for a many-thousand-image read."""
    def dec(pair):
        key, extra = pair
        try:
            return (key, extra, _decode_bytes(blobs[key]))
        except Exception:
            return (key, extra, None)  # None image == undecodable

    out, dropped = [], []
    for key, extra, img in zutils.parallel_map(dec, keyed):
        if img is None:
            dropped.append(key)
        else:
            out.append((key, extra, img))
    if dropped:
        logger.warning(
            "ImageSet.read: skipped %d of %d file(s) that failed to "
            "decode (first: %s)", len(dropped), len(keyed), dropped[0])
    return out


class ImageSet:
    """Collection of ImageFeatures with a lazy transform pipeline.

    `ImageSet.read(dir)` mirrors `ImageSet.read`
    (`ImageSet.scala:196`): reads every image under a path (glob or dir);
    `with_label_from_dirs` reads a `class_name/xxx.jpg` layout.
    """

    def __init__(self, features: "list[ImageFeature]"):
        self.features = features

    # -- readers ------------------------------------------------------------
    @staticmethod
    def read(path: str, with_label_from_dirs: bool = False,
             max_images: Optional[int] = None) -> "ImageSet":
        if zutils.is_dir(path):
            if with_label_from_dirs:
                class_dirs = zutils.list_dirs(path)
                label_map = {d: i for i, d in enumerate(class_dirs)}
                labelled = []          # (path, label) before decode
                for d in class_dirs:
                    for f in zutils.list_files(d):
                        labelled.append((f, label_map[d]))
                        if max_images and len(labelled) >= max_images:
                            break
                    if max_images and len(labelled) >= max_images:
                        break
                blobs = zutils.read_bytes_many([f for f, _ in labelled])
                return ImageSet([
                    ImageFeature(img, label=np.asarray([lbl], np.int32),
                                 uri=f)
                    for f, lbl, img in _decode_many(blobs, labelled)])
        files = zutils.list_files(path)
        if max_images:
            files = files[:max_images]
        blobs = zutils.read_bytes_many(files)
        return ImageSet([
            ImageFeature(img, uri=f)
            for f, _, img in _decode_many(blobs,
                                          [(f, None) for f in files])])

    @staticmethod
    def from_arrays(images: np.ndarray,
                    labels: Optional[np.ndarray] = None) -> "ImageSet":
        feats = []
        for i in range(len(images)):
            feats.append(ImageFeature(
                np.asarray(images[i]),
                label=None if labels is None else labels[i]))
        return ImageSet(feats)

    # -- pipeline -----------------------------------------------------------
    def transform(self, *transformers: Preprocessing) -> "ImageSet":
        feats = self.features
        for t in transformers:
            feats = [t.apply(f) for f in feats]
            feats = [f for f in feats if f is not None]
        return ImageSet(feats)

    def to_feature_set(self, memory_type="dram") -> FeatureSet:
        """→ FeatureSet of Samples (requires ImageSetToSample in the
        pipeline, or images already tensorized)."""
        samples = []
        for f in self.features:
            s = f.get(ImageFeature.SAMPLE)
            if s is None:
                s = Sample(feature=np.asarray(f.image, np.float32),
                           label=f.label)
            samples.append(s)
        return FeatureSet.sample_rdd(samples, memory_type=memory_type)

    def get_image(self) -> "list[np.ndarray]":
        return [f.image for f in self.features]

    def get_label(self) -> "list":
        return [f.label for f in self.features]

    def to_arrays(self) -> "tuple[np.ndarray, Optional[np.ndarray]]":
        """Stacked (images, labels-or-None) — lets an ImageSet be
        passed straight to `fit`/`evaluate`/`predict` like the
        reference's `model.fit(image_set, ...)` (TextSet has the same
        contract)."""
        xs = np.stack([np.asarray(f.image, np.float32)
                       for f in self.features])
        labels = [f.label for f in self.features]
        if any(lb is not None for lb in labels):
            ys = np.asarray([np.asarray(lb) for lb in labels])
            if ys.ndim == 1:
                ys = ys[:, None]
            return xs, ys
        return xs, None

    def __len__(self):
        return len(self.features)


LocalImageSet = ImageSet  # single-process variant name parity
