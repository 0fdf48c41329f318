"""ctypes loader for the C++ COCO matcher (this package's
``csrc/coco_eval.cpp``).

Port of ``snn_automotive_object_detection_tpu/evaluation/_native.py``: the
library is compiled on first use (g++ -O3) into this package's ``_build/``
(git-ignored), never beside the source. Without ``g++`` the matcher is not
there and ``coco_metrics`` runs its numpy loop, which gives the same
matches: host arithmetic either way, nothing on the device.
:func:`native_available` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "csrc", "coco_eval.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")


def _build(src: str, out: str) -> bool:
    """Compile ``src`` into ``out``; False when there is no ``g++`` or it
    fails (the numpy matcher then serves)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = _SRC
    so = os.path.join(_BUILD, "libcocoeval.so")
    if not os.path.exists(src):
        return None
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        if not _build(src, so):
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_u8_p = ctypes.POINTER(ctypes.c_uint8)
    c_i64_p = ctypes.POINTER(ctypes.c_int64)
    lib.coco_match.argtypes = [
        ctypes.c_int, ctypes.c_int,
        c_double_p, c_double_p, c_u8_p, c_double_p,
        c_double_p, ctypes.c_int,
        c_double_p, ctypes.c_int,
        c_i64_p, c_u8_p, c_i64_p,
    ]
    lib.coco_match.restype = None
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """True when the C++ matcher is built and loaded (it is built here on
    the first call), False when the numpy matcher runs."""
    return get_lib() is not None


def coco_match_native(ious, d_area, g_crowd, g_area, iou_thrs, area_rng):
    """Returns (dtm [na, nt, nd], dt_ig [na, nt, nd], num_gt [na]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    nd, ng = ious.shape
    nt = len(iou_thrs)
    na = len(area_rng)

    ious = np.ascontiguousarray(ious, np.float64)
    d_area = np.ascontiguousarray(d_area, np.float64)
    g_crowd = np.ascontiguousarray(g_crowd, np.uint8)
    g_area = np.ascontiguousarray(g_area, np.float64)
    thrs = np.ascontiguousarray(iou_thrs, np.float64)
    rng = np.ascontiguousarray(area_rng, np.float64)

    dtm = np.empty((na, nt, nd), np.int64)
    dt_ig = np.zeros((na, nt, nd), np.uint8)
    num_gt = np.zeros((na,), np.int64)

    dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.coco_match(
        nd, ng,
        dp(ious), dp(d_area),
        g_crowd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dp(g_area),
        dp(thrs), nt, dp(rng), na,
        dtm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dt_ig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        num_gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return dtm, dt_ig, num_gt
