"""Object-detection model family (port of
``analytics_zoo_tpu.models.image.objectdetection``; ref
models/image/objectdetection): SSD (VGG16-300/512, MobileNet-300) and
Faster-RCNN (VGG16, PVANet) as functional Keras graphs, the MultiBox
matching/mining loss, padded-NMS post-processing with no host sync, Pascal
VOC and COCO mAP evaluation and a PIL visualizer.
"""

from analytics_zoo_tpu_torch.models.image.objectdetection.priorbox import (
    PriorBoxSpec,
    generate_priors,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.ssd import (
    SSDConfig,
    ssd_mobilenet_300,
    ssd_vgg16_300,
    ssd_vgg16_512,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.loss import (
    MultiBoxLoss,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.detector import (
    ObjectDetectionConfig,
    ObjectDetector,
    Visualizer,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.evaluator import (
    MeanAveragePrecision,
    CocoEvaluator,
    PascalVocEvaluator,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.visualizer import (
    COCO_CLASSES,
    LabelReader,
    VisualizeDetections,
)

__all__ = [
    "PriorBoxSpec", "generate_priors", "SSDConfig", "ssd_vgg16_300",
    "ssd_vgg16_512", "ssd_mobilenet_300", "MultiBoxLoss",
    "ObjectDetectionConfig", "ObjectDetector", "Visualizer",
    "MeanAveragePrecision", "PascalVocEvaluator", "CocoEvaluator",
    "COCO_CLASSES", "LabelReader", "VisualizeDetections",
]
