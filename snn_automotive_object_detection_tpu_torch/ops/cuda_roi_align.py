"""Multi-level RoIAlign through the hand-written CUDA kernel (K2).

Replaces ``ops/pallas_roi_align.py`` (``multiscale_roi_align_pallas``).
The kernel is ``csrc/roi_align.cu``; its plain PyTorch version is the
gather formulation :func:`ops.roi_align.multiscale_roi_align`, which this
module re-exports as :data:`plain`. A CPU tensor takes the plain version;
a CUDA tensor launches the kernel (bf16 features, f32 boxes) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.ops.roi_align import (
    OUTPUT_SIZE,
    level_geometry,
    multiscale_roi_align,
)
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "roi_align"


def plain(features, boxes, image_size):
    """The plain PyTorch version (gather formulation)."""
    cb.note_plain(NAME, boxes)
    return multiscale_roi_align(features, boxes, image_size)


def _launch(features: Sequence[torch.Tensor], boxes: torch.Tensor,
            image_size: Tuple[int, int]) -> torch.Tensor:
    n, r, _ = boxes.shape
    c = features[0].shape[-1]
    for i, f in enumerate(features):
        cb.require(f, f"features[{i}]", torch.bfloat16)
        if f.dim() != 4 or f.shape[0] != n or f.shape[-1] != c:
            raise ValueError(f"features[{i}]: shape {tuple(f.shape)} does "
                             f"not match [{n}, H, W, {c}]")
    cb.require(boxes, "boxes", torch.float32, (n, r, 4))
    if len(features) > 5 or c % 2:
        raise ValueError("roi_align kernel takes at most 5 levels and an "
                         "even channel count")
    levels, scales = level_geometry(features, boxes, image_size)
    levels = levels.contiguous()
    out = torch.empty((n, r, OUTPUT_SIZE, OUTPUT_SIZE, c), dtype=torch.float32,
                      device=boxes.device)
    nl = len(features)
    lib = cb.load(NAME)
    fn = lib.roi_align_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    ptrs = (ctypes.c_int64 * nl)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * nl)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * nl)(*[f.shape[2] for f in features])
    sc = (ctypes.c_float * nl)(*scales)
    code = fn(ctypes.addressof(ptrs), ctypes.addressof(hs), ctypes.addressof(ws),
              ctypes.addressof(sc), nl, boxes.data_ptr(), levels.data_ptr(),
              n * r, r, c, out.data_ptr(), cb.stream_ptr(boxes.device))
    cb.check(code, NAME)
    cb.LAUNCHES[NAME] += 1
    return out


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              image_size: Tuple[int, int]) -> torch.Tensor:
    """[N, R, 7, 7, C] float32 RoIAlign of ``boxes`` [N, R, 4] over the
    pooled levels ``features`` (list of [N, H_l, W_l, C])."""
    if cb.dispatch_device(boxes, NAME):
        return _launch(features, boxes, image_size)
    return plain(features, boxes, image_size)
