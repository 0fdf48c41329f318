"""Evaluation: the COCO bbox protocol on the host (numpy, and the C++
matcher where ``g++`` builds it). Port of
``snn_automotive_object_detection_tpu/evaluation``; the 12 summary stats
are pycocotools'."""

from snn_automotive_object_detection_tpu_torch.evaluation.coco_metrics import COCOEval
from snn_automotive_object_detection_tpu_torch.evaluation.evaluator import CocoEvaluator
