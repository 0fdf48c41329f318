"""Multi-level RoIAlign through the hand-written CUDA kernel (K2).

Replaces ``ops/pallas_roi_align.py`` (``multiscale_roi_align_pallas``).
The kernel is ``csrc/roi_align.cu``; its plain PyTorch version is the
gather formulation :func:`ops.roi_align.multiscale_roi_align`, which this
module re-exports as :data:`plain`. A CPU tensor takes the plain version;
a CUDA tensor launches the kernel (bf16 features, f32 boxes, C a multiple
of 8) or raises.

On the CUDA route a call is one launch and no other device op: the kernel
maps each box to its level itself (``assign_fpn_levels``' float
expressions), and the host passes only what follows from the shapes: the
levels' sizes and scales and the mapper's level range (:func:`geometry`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from snn_automotive_object_detection_tpu_torch.ops.roi_align import (
    OUTPUT_SIZE,
    infer_scales,
    level_range,
    multiscale_roi_align,
)
from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

NAME = "roi_align"
MAX_LEVELS = 5
_ARGTYPES = [ctypes.c_void_p] * (MAX_LEVELS + 2) + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


class Geometry(ctypes.Structure):
    """The kernel's ``Geometry``: the levels' sizes and scales and the
    mapper's level range, passed by address."""
    _fields_ = [("num_levels", ctypes.c_int), ("k_min", ctypes.c_int),
                ("k_max", ctypes.c_int), ("h", ctypes.c_int * MAX_LEVELS),
                ("w", ctypes.c_int * MAX_LEVELS), ("scale", ctypes.c_float * MAX_LEVELS)]


def plain(features, boxes, image_size):
    """The plain PyTorch version (gather formulation)."""
    cb.note_plain(NAME, boxes)
    return multiscale_roi_align(features, boxes, image_size)


@functools.lru_cache(maxsize=64)
def geometry(shapes: Tuple[Tuple[int, int], ...], image_size: Tuple[int, int]) -> Geometry:
    """What the kernel takes besides pointers, from the levels' (H, W): the
    levels' sizes and scales, each padded to ``MAX_LEVELS`` with the first
    level's entry (the kernel ignores it), and the mapper's level range.
    Built once per set of shapes; the cache keeps it alive while the
    kernel's host side reads it. Raises ``ValueError`` on more levels than
    the kernel takes or a level range the levels do not cover."""
    nl = len(shapes)
    scales = infer_scales(shapes, image_size)
    k_min, k_max = level_range(scales)
    if not 1 <= nl <= MAX_LEVELS or not 0 <= k_max - k_min < nl:
        raise ValueError(f"roi_align kernel: {nl} levels of scales {scales} "
                         f"(at most {MAX_LEVELS}, mapper range [{k_min}, {k_max}])")
    pad = MAX_LEVELS - nl
    padded = tuple(shapes) + tuple(shapes[:1]) * pad
    return Geometry(nl, k_min, k_max, (ctypes.c_int * MAX_LEVELS)(*[h for h, _ in padded]),
                    (ctypes.c_int * MAX_LEVELS)(*[w for _, w in padded]),
                    (ctypes.c_float * MAX_LEVELS)(*(scales + scales[:1] * pad)))


def _launch(features: Sequence[torch.Tensor], boxes: torch.Tensor,
            image_size: Tuple[int, int]) -> torch.Tensor:
    n, r = boxes.shape[:2]
    c = features[0].shape[-1]
    cb.require(boxes, "boxes", torch.float32, (n, r, 4))
    ptrs, shapes = [], []
    for f in features:
        cb.require(f, "features", torch.bfloat16)
        sh = f.shape
        if len(sh) != 4 or sh[0] != n or sh[3] != c:
            raise ValueError(f"features: shape {tuple(sh)} does not match "
                             f"[{n}, H, W, {c}]")
        ptrs.append(f.data_ptr())
        shapes.append((sh[1], sh[2]))
    if c % 8:
        raise ValueError(f"roi_align kernel: C = {c}; it reads 8 channels "
                         f"(16 bytes) a thread and takes a multiple of 8")
    geo = geometry(tuple(shapes), tuple(image_size))
    out = torch.empty((n, r, OUTPUT_SIZE, OUTPUT_SIZE, c), dtype=torch.float32,
                      device=boxes.device)
    ptrs += ptrs[:1] * (MAX_LEVELS - len(ptrs))
    fn = cb.function(NAME, "roi_align_bf16", _ARGTYPES)
    code = fn(*ptrs, ctypes.addressof(geo), boxes.data_ptr(), n * r, r, c,
              out.data_ptr(), cb.stream_ptr(boxes.device))
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
