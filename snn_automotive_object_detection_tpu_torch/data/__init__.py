"""Host-side input pipeline: datasets, transforms, bucketed batch loader.

Port of ``snn_automotive_object_detection_tpu/data``. The model consumes
fixed-shape batches; all variable-size work (decode, resize, augment, pad,
GT packing) happens here on the host, overlapped with the device's work by
worker threads, and ``to_device_batch`` moves a batch onto the card.
"""

from snn_automotive_object_detection_tpu_torch.data.coco import CocoDataset, CocoIndex
from snn_automotive_object_detection_tpu_torch.data.idd import IDDDataset
from snn_automotive_object_detection_tpu_torch.data.loader import (
    DetectionLoader,
    to_device_batch,
)
from snn_automotive_object_detection_tpu_torch.data.registry import create_dataset
