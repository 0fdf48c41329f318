"""Build and load the hand-written CUDA kernels, and count their launches.

Each ``csrc/<source>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``
(:data:`SOURCE` names each kernel's source; K8 shares K1's). The
build happens at first use (or all at once, in parallel, through
:func:`build_all`) into ``_build/`` beside this package's sources, which
``.gitignore`` lists. A library is rebuilt when its source, or a header
(``csrc/*.cuh``) that sources share, is newer.

``--fmad=false`` keeps every float multiply and add separately rounded, so
the neuron-state arithmetic matches the plain PyTorch versions (and the
JAX reference) operation for operation.

Every wrapper that launches a kernel adds one to ``LAUNCHES[name]`` and
nowhere else; every plain version that runs on a CUDA tensor adds one to
``PLAIN_CUDA_CALLS[name]``, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

KERNELS = ("rpn_head", "roi_align", "encoder_fc6", "box_tail", "fpn_level",
           "stem", "rpn_head_bwd", "rpn_head_x2", "box_head_fused", "rpn_head_s16",
           "rpn_head_s16_save", "rpn_head_bwd_s16", "rpn_head_x2_s16")
# The source csrc/<source>.cu, and library, of each kernel: the paired RPN
# head (K8) and the RPN head's instances for bf16 neuron states (evaluation,
# training, pair) are instances of K1's kernel and live in K1's source; the
# backward's bf16-state instance lives in K7's.
SOURCE = {**{k: k for k in KERNELS}, "rpn_head_x2": "rpn_head", "rpn_head_s16": "rpn_head",
          "rpn_head_s16_save": "rpn_head", "rpn_head_x2_s16": "rpn_head",
          "rpn_head_bwd_s16": "rpn_head_bwd"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
PLAIN_CUDA_CALLS: Dict[str, int] = {k: 0 for k in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CUDA_CALLS):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str):
    src = SOURCE[name]
    return CSRC_DIR / f"{src}.cu", BUILD_DIR / f"lib{src}.so", \
        BUILD_DIR / f"{src}.ptxas.log"


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    newest = max(f.stat().st_mtime for f in (src, *CSRC_DIR.glob("*.cuh")))
    return not lib.exists() or lib.stat().st_mtime < newest


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the stale libraries of the kernels ``names``, one ``nvcc``
    per source, all started together. Returns {source: ptxas report};
    raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in dict.fromkeys(SOURCE[n] for n in names):
        src, lib, log = _paths(name)
        if not _stale(name):
            continue
        tmp = lib.with_suffix(f".so.{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        _, lib, log = _paths(name)
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _paths(n)[2].read_text() for n in dict.fromkeys(SOURCE[n] for n in names)
            if _paths(n)[2].exists()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    name = SOURCE[name]
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of the library for ``name``, its argument and result
    types set once per process: a wrapper that looks it up here does no
    ctypes set-up on its calls."""
    fn = _FUNCS.get((SOURCE[name], symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _FUNCS[(SOURCE[name], symbol)] = fn
    return fn


def stream_ptr(device: torch.device) -> int:
    """The current stream's handle on the CUDA ``device``, without making
    a stream object: a plain integer from PyTorch's C layer."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError`` code from a launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")


def require(t: torch.Tensor, what: str, dtype: torch.dtype, shape=None) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity, alignment and
    shape."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels read 16-byte vectors; the data "
                         f"pointer must be 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def note_plain(name: str, t: torch.Tensor) -> None:
    """Called by each plain version: counts runs on a CUDA tensor."""
    if t.is_cuda:
        PLAIN_CUDA_CALLS[name] += 1


def dispatch_device(t: torch.Tensor, name: str) -> bool:
    """True when the kernel must launch (CUDA tensor), False for the plain
    version (CPU tensor); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")
