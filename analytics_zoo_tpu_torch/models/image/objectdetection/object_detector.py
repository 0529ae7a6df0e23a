"""ObjectDetector, its configuration registry and the VOC/COCO readers
(port of ``analytics_zoo_tpu/models/image/objectdetection/
object_detector.py``).

``ObjectDetector`` is a ZooModel over SSD: build, load by published name
(``models.config.ObjectDetectionConfig``), train with
``compile_detection`` on ``pack_targets``' padded ground truth, and
``detect`` (the net on its device, ``DetectionOutput`` on the host).
The readers are the standard library's xml and json, as in the
reference.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.image.objectdetection.detection import (
    Detection, DetectionOutput)
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
    import MultiBoxLoss
from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import SSDVGG

VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor")


@dataclass
class ObjectDetectionConfig:
    """A published detector's architecture, input size, classes,
    preprocessing mean and post-processing thresholds."""

    arch: str = "ssd-vgg16"
    img_size: int = 300
    n_classes: int = 21
    class_names: Sequence[str] = VOC_CLASSES
    mean: "tuple" = (123.0, 117.0, 104.0)
    conf_threshold: float = 0.01
    nms_threshold: float = 0.45


CONFIGS: "dict[str, ObjectDetectionConfig]" = {
    "ssd-vgg16-300x300": ObjectDetectionConfig(),
    "ssd-vgg16-300x300-voc": ObjectDetectionConfig(),
}


class ObjectDetector(ZooModel):
    """SSD object detection as a ZooModel."""

    def __init__(self, model_name: str = "ssd-vgg16-300x300",
                 n_classes: Optional[int] = None,
                 img_size: Optional[int] = None):
        super().__init__()
        if model_name not in CONFIGS:
            raise ValueError(f"unknown detection model '{model_name}'; "
                             f"known: {sorted(CONFIGS)}")
        cfg = CONFIGS[model_name]
        self.model_name = model_name
        self.config = cfg
        self.n_classes = int(n_classes or cfg.n_classes)
        self.img_size = int(img_size or cfg.img_size)
        self._builder = SSDVGG(self.n_classes, self.img_size)
        self.priors = self._builder.priors

    def hyper_parameters(self):
        return {"model_name": self.model_name,
                "n_classes": self.n_classes,
                "img_size": self.img_size}

    def build_model(self):
        return self._builder.build()

    @classmethod
    def load_model(cls, path_or_name: str, weights_path=None,
                   n_classes=None, img_size=None,
                   allow_random: bool = False):
        """Load by name or path: a known variant's name builds it and
        loads local weights (``ObjectDetectionConfig.create``; raising
        when none is found unless ``allow_random=True``); another
        string is a ``save_model`` file."""
        from analytics_zoo_tpu_torch.models.config import (
            ObjectDetectionConfig, _resolve_weights,
            _strip_published_name)
        arch = _strip_published_name(path_or_name).lower()
        if arch in CONFIGS or _resolve_weights(
                path_or_name, arch, None) is not None:
            return ObjectDetectionConfig.create(
                path_or_name, n_classes=n_classes, img_size=img_size,
                weights_path=weights_path, allow_random=allow_random)
        return super().load_model(path_or_name)

    # -- training -----------------------------------------------------------
    def compile_detection(self, optimizer="sgd",
                          iou_threshold: float = 0.5,
                          neg_pos_ratio: float = 3.0):
        _ = self.model  # building refreshes the builder's prior layout
        self.priors = np.asarray(self._builder.priors)
        loss = MultiBoxLoss(self.n_classes, iou_threshold,
                            neg_pos_ratio).as_keras_loss(
            np.asarray(self.priors))
        self.compile(optimizer=optimizer, loss=loss)
        return self

    @staticmethod
    def pack_targets(gt_boxes: "list[np.ndarray]",
                     gt_labels: "list[np.ndarray]",
                     max_gt: int = 32) -> np.ndarray:
        """Pad each image's GT into the fixed-size ``y_true`` layout the
        MultiBox loss takes (label -1 pads)."""
        b = len(gt_boxes)
        boxes = np.zeros((b, max_gt, 4), np.float32)
        labels = np.full((b, max_gt), -1.0, np.float32)
        for i, (bx, lb) in enumerate(zip(gt_boxes, gt_labels)):
            n = min(len(lb), max_gt)
            if n:
                boxes[i, :n] = np.asarray(bx)[:n]
                labels[i, :n] = np.asarray(lb)[:n]
        return np.concatenate(
            [boxes.reshape(b, -1), labels], axis=1)

    # -- inference ----------------------------------------------------------
    def detect(self, images: np.ndarray, batch_size: int = 8,
               conf_threshold: Optional[float] = None
               ) -> "list[list[Detection]]":
        """images: (B, H, W, 3), a host array or a tensor, already
        resized and mean-subtracted. A bf16 tensor serves the net in
        bf16 (its f32 weights cast per layer); the detections come from
        the f32 widening of its output."""
        _ = self.model
        self.priors = np.asarray(self._builder.priors)
        flat = self.predict(images, batch_size=batch_size)
        post = DetectionOutput(
            self.n_classes,
            conf_threshold=(conf_threshold if conf_threshold is not None
                            else self.config.conf_threshold),
            nms_threshold=self.config.nms_threshold)
        return post.from_flat(np.asarray(flat), np.asarray(self.priors))


# -- datasets ----------------------------------------------------------------

class PascalVocDataset:
    """Reads a VOCdevkit layout: Annotations/*.xml + JPEGImages/*."""

    def __init__(self, root: str,
                 class_names: Sequence[str] = VOC_CLASSES):
        self.root = root
        self.class_to_id = {c: i for i, c in enumerate(class_names)}

    def read_annotations(self) -> "list[dict]":
        ann_dir = os.path.join(self.root, "Annotations")
        out = []
        for fname in sorted(os.listdir(ann_dir)):
            if not fname.endswith(".xml"):
                continue
            tree = ET.parse(os.path.join(ann_dir, fname))
            size = tree.find("size")
            w = float(size.find("width").text)
            h = float(size.find("height").text)
            boxes, labels = [], []
            for obj in tree.iter("object"):
                name = obj.find("name").text
                if name not in self.class_to_id:
                    continue
                bb = obj.find("bndbox")
                boxes.append([
                    float(bb.find("xmin").text) / w,
                    float(bb.find("ymin").text) / h,
                    float(bb.find("xmax").text) / w,
                    float(bb.find("ymax").text) / h])
                labels.append(self.class_to_id[name])
            img = tree.find("filename").text
            out.append({
                "image": os.path.join(self.root, "JPEGImages", img),
                "boxes": np.asarray(boxes, np.float32),
                "labels": np.asarray(labels, np.int32)})
        return out


class CocoDataset:
    """Reads a COCO instances json (boxes normalized to corners)."""

    def __init__(self, annotation_json: str, image_root: str = ""):
        self.annotation_json = annotation_json
        self.image_root = image_root

    def read_annotations(self) -> "list[dict]":
        with open(self.annotation_json) as f:
            coco = json.load(f)
        images = {im["id"]: im for im in coco["images"]}
        cat_ids = sorted(c["id"] for c in coco["categories"])
        cat_to_label = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        per_image: "dict[int, dict]" = {}
        for ann in coco["annotations"]:
            im = images[ann["image_id"]]
            w, h = float(im["width"]), float(im["height"])
            x, y, bw, bh = ann["bbox"]
            entry = per_image.setdefault(ann["image_id"], {
                "image": os.path.join(self.image_root,
                                      im["file_name"]),
                "boxes": [], "labels": []})
            entry["boxes"].append([x / w, y / h, (x + bw) / w,
                                   (y + bh) / h])
            entry["labels"].append(cat_to_label[ann["category_id"]])
        return [{"image": v["image"],
                 "boxes": np.asarray(v["boxes"], np.float32),
                 "labels": np.asarray(v["labels"], np.int32)}
                for v in per_image.values()]
