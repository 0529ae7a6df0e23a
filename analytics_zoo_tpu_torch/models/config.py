"""Pretrained-model registries: a published name → an architecture and
its weights (port of ``analytics_zoo_tpu/models/config.py``).

Weights come from local files only, found in this order:

1. an explicit ``weights_path=`` (a ``.npz`` weight file, or a
   reference-format BigDL/zoo ``.model``);
2. ``$ZOO_TPU_PRETRAINED_DIR/<published name or arch>.{npz,model}``
   when that variable is set, every ``.npz`` before any ``.model``;
3. nothing found: ``FileNotFoundError``, unless ``allow_random=True``
   (the architecture with random weights, and a log line), since a
   silently untrained "pretrained" model is a correctness trap.

``.npz`` weights are shape-checked against the built architecture
(``ZooModel.load_weights``). A ``.model`` artifact defines the model
(the reference's ``ZooModel.loadModel``): it is imported whole through
``Net.load_bigdl`` and returned as the reference returns it, adopted by
an ``ImageClassifier``/``ObjectDetector`` of a known architecture or an
``ImportedZooModel`` otherwise; a file that does not parse raises, and
never falls back to random weights.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from analytics_zoo_tpu_torch.common.nncontext import logger


def _resolve_weights(name: str, arch: str,
                     weights_path: Optional[str]) -> Optional[str]:
    """Find a weights artifact for ``name`` (the full published name)
    or ``arch`` (the bare architecture): the explicit path first, then
    ``$ZOO_TPU_PRETRAINED_DIR`` under both names, .npz before .model."""
    if weights_path is not None:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(weights_path)
        return weights_path
    root = os.environ.get("ZOO_TPU_PRETRAINED_DIR")
    if root:
        for ext in (".npz", ".model"):
            for stem in dict.fromkeys((name, arch)):    # ordered, deduped
                cand = os.path.join(root, stem + ext)
                if os.path.exists(cand):
                    return cand
    return None


def _missing_weights_error(kind: str, name: str) -> FileNotFoundError:
    return FileNotFoundError(
        f"{kind}: no pretrained weights found for {name!r} — pass "
        f"weights_path= (.npz or reference .model), or place "
        f"<name>.npz/.model under $ZOO_TPU_PRETRAINED_DIR, or pass "
        f"allow_random=True for an untrained architecture")


def _load_bigdl_artifact(kind: str, arch: str, path: str,
                         ignored_args: dict, wrapper=None):
    """Import a reference ``.model`` artifact whole through
    ``Net.load_bigdl``: adopted by ``wrapper`` (a model of a known
    architecture, keeping its surface) or, for other architectures,
    returned as an ``ImportedZooModel``. Arguments the artifact's own
    architecture overrides are logged."""
    from analytics_zoo_tpu_torch.pipeline.api.net_load import Net
    dropped = {k: v for k, v in ignored_args.items() if v is not None}
    if dropped:
        logger.warning(
            "%s: %s resolves to a .model artifact whose saved "
            "architecture takes precedence — ignoring %s", kind, arch,
            dropped)
    logger.info("%s: %s loaded from reference artifact %s",
                kind, arch, path)
    net = Net.load_bigdl(path)
    if wrapper is not None:
        wrapper._model = net
        return wrapper
    from analytics_zoo_tpu_torch.models.common import ImportedZooModel
    return ImportedZooModel(path, model_name=arch, net=net)


def _strip_published_name(name: str) -> str:
    """Accept the reference's full published names
    (``analytics-zoo_<arch>_<dataset>_<version>``) as well as bare
    architecture names."""
    parts = name.split("_")
    if len(parts) >= 2 and parts[0] in ("analytics-zoo", "zoo"):
        return parts[1]
    return name


class ImageClassificationConfig:
    """The published classification models (reference
    ``ImageClassificationConfig``)."""

    @staticmethod
    def names() -> Tuple[str, ...]:
        from analytics_zoo_tpu_torch.models.image.imageclassification \
            import ImageClassifier
        return tuple(ImageClassifier.ARCHS)

    @staticmethod
    def create(name: str, input_shape=(224, 224, 3), classes: int = 1000,
               weights_path: Optional[str] = None,
               allow_random: bool = False):
        from analytics_zoo_tpu_torch.models.image.imageclassification \
            import ImageClassifier
        arch = _strip_published_name(name).lower()
        wp = _resolve_weights(name, arch, weights_path)
        if wp is None and not allow_random:
            raise _missing_weights_error("ImageClassificationConfig",
                                         name)
        if wp is not None and wp.endswith(".model"):
            wrapper = None
            if arch in ImageClassifier.ARCHS:
                wrapper = ImageClassifier(model_name=arch,
                                          input_shape=input_shape,
                                          classes=classes)
            return _load_bigdl_artifact(
                "ImageClassificationConfig", arch, wp,
                {"input_shape": (None if tuple(input_shape) == (224, 224, 3)
                                 else input_shape),
                 "classes": None if classes == 1000 else classes},
                wrapper=wrapper)
        model = ImageClassifier(model_name=arch, input_shape=input_shape,
                                classes=classes)
        model.compile()
        if wp is not None:
            model.load_weights(wp)
            logger.info("ImageClassificationConfig: %s weights from %s",
                        arch, wp)
        else:
            logger.info("ImageClassificationConfig: %s randomly "
                        "initialized (allow_random=True)", arch)
        return model


class ObjectDetectionConfig:
    """The published detection models (reference
    ``ObjectDetectionConfig``)."""

    @staticmethod
    def names() -> Tuple[str, ...]:
        from analytics_zoo_tpu_torch.models.image.objectdetection \
            .object_detector import CONFIGS
        return tuple(sorted(CONFIGS))

    @staticmethod
    def create(name: str, n_classes: Optional[int] = None,
               img_size: Optional[int] = None,
               weights_path: Optional[str] = None,
               allow_random: bool = False):
        from analytics_zoo_tpu_torch.models.image.objectdetection import \
            ObjectDetector
        arch = _strip_published_name(name).lower()
        wp = _resolve_weights(name, arch, weights_path)
        if wp is None and not allow_random:
            raise _missing_weights_error("ObjectDetectionConfig", name)
        if wp is not None and wp.endswith(".model"):
            wrapper = None
            if arch in ObjectDetectionConfig.names():
                wrapper = ObjectDetector(model_name=arch,
                                         n_classes=n_classes,
                                         img_size=img_size)
            return _load_bigdl_artifact(
                "ObjectDetectionConfig", arch, wp,
                {"n_classes": n_classes, "img_size": img_size},
                wrapper=wrapper)
        model = ObjectDetector(model_name=arch, n_classes=n_classes,
                               img_size=img_size)
        model.compile()
        if wp is not None:
            model.load_weights(wp)
            logger.info("ObjectDetectionConfig: %s weights from %s",
                        arch, wp)
        else:
            logger.info("ObjectDetectionConfig: %s randomly "
                        "initialized (allow_random=True)", arch)
        return model
