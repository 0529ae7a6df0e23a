"""Object detection of the port: SSD300-VGG16, its loss, priors,
post-processing, evaluation and dataset readers."""

from analytics_zoo_tpu_torch.models.image.objectdetection import bbox_util
from analytics_zoo_tpu_torch.models.image.objectdetection.bbox_util import (
    clip_boxes, decode_boxes, encode_boxes, iou_matrix, nms)
from analytics_zoo_tpu_torch.models.image.objectdetection.detection import (
    Detection, DetectionOutput, Visualizer)
from analytics_zoo_tpu_torch.models.image.objectdetection.evaluation import (
    MeanAveragePrecision)
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
    import MultiBoxLoss, match_priors
from analytics_zoo_tpu_torch.models.image.objectdetection.object_detector \
    import CocoDataset, ObjectDetector, PascalVocDataset
from analytics_zoo_tpu_torch.models.image.objectdetection.prior_box import (
    PriorBoxSpec, generate_ssd_priors)
from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import (
    SSDVGG, ssd300_vgg16)

__all__ = [
    "bbox_util", "iou_matrix", "encode_boxes", "decode_boxes", "nms",
    "clip_boxes", "PriorBoxSpec", "generate_ssd_priors", "MultiBoxLoss",
    "match_priors", "Detection", "DetectionOutput", "Visualizer",
    "MeanAveragePrecision", "SSDVGG", "ssd300_vgg16", "ObjectDetector",
    "PascalVocDataset", "CocoDataset",
]
