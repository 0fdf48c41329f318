#!/usr/bin/env python3
"""Time the ``wgmma`` kernels with parts of them switched off, on one
NVIDIA GPU.

    python3 chip_diagnose.py            # K1, K5, K3, K4 and K7
    python3 chip_diagnose.py K3 K4      # only those kernels' variants

Shows what limits K1, K5, K3, K4 and K7's weight gradient. Each variant
below replaces lines of ``csrc/rpn_head.cu`` (K1), ``csrc/fpn_level.cu``
(K5), ``csrc/spike_gemm.cuh`` (the spike-code GEMM of K3 and K4) or
``csrc/rpn_head_bwd.cu`` (K7) in a copy of
``csrc/`` in a temporary directory (the repository is never edited). All
variants build at once, one ``nvcc`` each with the package's flags, and
each is timed with CUDA events (median of 10) at the flagship shapes
through the kernel's C interface, so no wrapper's host work is in the
times: K1 on the five RPN levels of an image pair at T = 8 with 15 readout
channels, K5 on C2..C5 with 8-row and with 4-row tiles, K3 on x [2000,
12544] at T = 12, K4 on cur6 [12, 2000, 1024] with 45 readout columns, K7's
weight gradient alone (its C interface with only that phase) on random dc
planes and period maps of the five levels at T = 8. A
variant with the products or the A build switched off computes wrong
numbers; only its time means anything.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CLUSTER_OF_ONE = [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")]
# The replacements keep A and the stage's descriptor live, so that the A
# build and the wait for the stage stay in the loop.
K1_NO_PRODUCTS = [
    ("for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs_n256(acc, a[kk], db + kk * 2);",
     "for (int kk = 0; kk < kK / 16; ++kk) acc[kk] += __uint_as_float("
     "a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3]) + (float)(db & 1);")]
K1_NO_A_BUILD = [
    (f"a[kk][{i}] = spike_pair(*reinterpret_cast<const uint16_t*>({p}), mask);",
     f"a[kk][{i}] = (uint32_t)mask;")
    for i, p in enumerate(("p", "p + 8 * kLdp", "p + 8", "p + 8 * kLdp + 8"))]
K5_NO_PRODUCTS = [
    ("""          if constexpr (kN == 256) {
            wgmma_rs_n256(acc, a[kk], db + kk * 2);
          } else {
            wgmma_rs_n128(acc, a[kk], db + kk * 2);
          }""", "acc[kk] += __uint_as_float(a[kk][0] ^ a[kk][3]) + (float)(db & 1);"),
    ("wgmma_ss_n128(acc[mt], da + mt * (64 * kLatK * 2 >> 4) + kk * 2, db + kk * 2);",
     "acc[mt][kk] += (float)((da ^ db) & 1);")]

# The spike-code GEMM (K3, and K4's fc7 and readout): products replaced by
# a use of A and the descriptor; A built from a constant, not the codes.
SG_NO_PRODUCTS = [
    ("for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs<kN>(acc[0], a[0][kk], db + kk * 128);",
     "for (int kk = 0; kk < kK / 16; ++kk) acc[0][kk] += __uint_as_float("
     "a[0][kk][0] ^ a[0][kk][1] ^ a[0][kk][2] ^ a[0][kk][3]) + (float)(db & 1);"),
    ("for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs<kN>(acc[1], a[kMt - 1][kk], db + kk * 128);",
     "for (int kk = 0; kk < kK / 16; ++kk) acc[1][kk] += __uint_as_float("
     "a[kMt - 1][kk][0] ^ a[kMt - 1][kk][3]) + (float)(db & 1);")]
SG_NO_A_BUILD = [
    ("a[0][kk][i] = ((pair[i] >> t0) & 0x10001u) * 0x3F80u;",
     "a[0][kk][i] = (uint32_t)(t0 + kk + i);"),
    ("if constexpr (kMt == 2) a[kMt - 1][kk][i] = ((pair[i] >> t1) & 0x10001u) * 0x3F80u;",
     "if constexpr (kMt == 2) a[kMt - 1][kk][i] = (uint32_t)(t1 + kk + i);")]

# K7's weight gradient: products replaced by a use of A and the
# descriptor; A built from the step masks, not the period bytes.
K7_NO_PRODUCTS = [
    ("for (int kk = 0; kk < kK / 16; ++kk) wgmma_rs_n256_tb(acc, a[kk], db + kk * 128);",
     "for (int kk = 0; kk < kK / 16; ++kk) acc[kk] += __uint_as_float("
     "a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3]) + (float)(db & 1);")]
K7_NO_A_BUILD = [
    ("a[kk][2 * h] = spike_pair(q[0], lo[j], hi[j]);", "a[kk][2 * h] = (uint32_t)lo[j] + kk;"),
    ("a[kk][2 * h + 1] = spike_pair(q[8], lo[j], hi[j]);",
     "a[kk][2 * h + 1] = (uint32_t)hi[j] + h;")]

# (kernel, variant, replacements)
VARIANTS = [
    ("K1", "as built", []),
    ("K1", "one block per cluster", CLUSTER_OF_ONE),
    ("K1", "no products", K1_NO_PRODUCTS),
    ("K1", "no A build", K1_NO_A_BUILD),
    ("K1", "weight stream only", K1_NO_PRODUCTS + K1_NO_A_BUILD),
    ("K1", "weight stream only, one block per cluster",
     CLUSTER_OF_ONE + K1_NO_PRODUCTS + K1_NO_A_BUILD),
    ("K5", "as built", []),
    ("K5", "one block per cluster", CLUSTER_OF_ONE),
    ("K5", "no products", K5_NO_PRODUCTS),
    ("K5", "no products, one block per cluster", CLUSTER_OF_ONE + K5_NO_PRODUCTS),
] + [(k, v, subs) for k in ("K3", "K4") for v, subs in (
    ("as built", []),
    ("one block per cluster", CLUSTER_OF_ONE),
    ("no products", SG_NO_PRODUCTS),
    ("no A build", SG_NO_A_BUILD),
    ("weight stream only", SG_NO_PRODUCTS + SG_NO_A_BUILD))] + [
    ("K7", "as built", []),
    ("K7", "no products", K7_NO_PRODUCTS),
    ("K7", "no A build", K7_NO_A_BUILD),
    ("K7", "dc stream only", K7_NO_PRODUCTS + K7_NO_A_BUILD)]
# (the file the replacements patch, the source built)
SOURCE = {"K1": ("rpn_head.cu", "rpn_head.cu"), "K5": ("fpn_level.cu", "fpn_level.cu"),
          "K3": ("spike_gemm.cuh", "encoder_fc6.cu"), "K4": ("spike_gemm.cuh", "box_tail.cu"),
          "K7": ("rpn_head_bwd.cu", "rpn_head_bwd.cu")}


def build(tmp: Path, variants):
    """Every variant's library, built in parallel; returns [ctypes.CDLL]."""
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    procs = []
    for i, (kernel, variant, subs) in enumerate(variants):
        src = tmp / f"v{i}"
        shutil.copytree(cb.CSRC_DIR, src)
        patched, built = SOURCE[kernel]
        cu = src / patched
        text = cu.read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"chip_diagnose: {kernel} {variant}: a line to replace "
                                 f"is not there once: {old[:60]!r}")
            text = text.replace(old, new)
        cu.write_text(text)
        lib = src / "lib.so"
        procs.append((subprocess.Popen([cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(lib),
                                        str(src / built)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib))
    libs = []
    for (kernel, variant, _), (proc, lib) in zip(variants, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chip_diagnose: {kernel} {variant} does not build:\n{out}")
        regs = [line.split(":")[-1].strip() for line in out.splitlines()
                if "Used" in line or "spill" in line]
        print(f"{kernel} {variant}: {'; '.join(regs)}")
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_diagnose: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn as k5
    from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    chosen = [v for v in VARIANTS if not sys.argv[1:] or v[0] in sys.argv[1:]]

    chip_smoke.reference_numerics()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    stream = cb.stream_ptr(dev)

    # K1: features in the encoder's range (about a quarter of them spike).
    levels = [(192, 384), (96, 192), (48, 96), (24, 48), (12, 24)]
    feats = [torch.rand((2, h, w, 256), generator=g, device=dev).mul(2.0).to(bf)
             for h, w in levels]
    w9_t = k1._taps_t(torch.randn((3, 3, 256, 256), generator=g, device=dev) * 0.01)
    wout = (torch.randn((256, 15), generator=g, device=dev) * 0.01).to(bf)
    consts = k1._constants(8, dev)

    def k1_run(lib, f):
        n, h, w, _ = f.shape
        out = torch.empty((n, h, w, 15), device=dev)
        counts = torch.zeros((n, 2), dtype=torch.int64, device=dev)
        fn = lib.rpn_level_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        cb.check(fn(f.data_ptr(), w9_t.data_ptr(), wout.data_ptr(), consts.data_ptr(),
                    out.data_ptr(), counts.data_ptr(), None, n, h, w, 8, 15, stream), "K1")

    # K5: the flagship levels, scaled as chip_smoke.check_fpn scales them;
    # every level but C2 stores its merged map, as on the main path.
    shapes = [(192, 384, 256), (96, 192, 512), (48, 96, 1024), (24, 48, 2048)]
    cs = [torch.randn((2, h, w, c), generator=g, device=dev).to(bf) for h, w, c in shapes]
    ws = [k5.kernel_weights(torch.randn((1, 1, c, 256), generator=g, device=dev) / c ** 0.5,
                            torch.randn(256, generator=g, device=dev) * 0.1,
                            torch.randn((3, 3, 256, 256), generator=g, device=dev) / 48.0,
                            torch.randn(256, generator=g, device=dev) * 0.1)
          for _, _, c in shapes]
    nexts = [torch.randn((2, (h + 1) // 2, (w + 1) // 2, 256), generator=g, device=dev).to(bf)
             for h, w, _ in shapes[:3]] + [None]

    def k5_run(lib, i, rows):
        c = cs[i]
        n, h, w, cin = c.shape
        wlat_t, blat, w9t, bout = ws[i]
        p = torch.empty((n, h, w, 256), dtype=bf, device=dev)
        m = torch.empty_like(p) if i > 0 else None
        fn = lib.fpn_level_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        cb.check(fn(c.data_ptr(), None if nexts[i] is None else nexts[i].data_ptr(),
                    wlat_t.data_ptr(), blat.data_ptr(), w9t.data_ptr(), bout.data_ptr(),
                    p.data_ptr(), None if m is None else m.data_ptr(), n, h, w, cin, rows,
                    stream), "K5")

    # K3: x in the encoder's range; w6 and the thresholds as the wrapper
    # passes them.
    x = (torch.rand((2000, 12544), generator=g, device=dev) * 2.5).to(bf)
    w6 = ((torch.rand((12544, 1024), generator=g, device=dev) * 2 - 1) / 112.0).to(bf)
    thr = k3._thresholds(12, dev)
    cur6_f = torch.empty((12, 2000, 1024), device=dev)
    enc_counts = torch.zeros(2000, dtype=torch.int32, device=dev)
    x_codes = torch.empty((2000, 12544), dtype=torch.int16, device=dev)

    def k3_run(lib):
        fn = lib.encoder_fc6_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        cb.check(fn(x.data_ptr(), w6.data_ptr(), thr.data_ptr(), cur6_f.data_ptr(),
                    enc_counts.data_ptr(), x_codes.data_ptr(), 2000, 12544, 1024, 12, stream),
                 "K3")

    # K4: fc6 currents around the LIF threshold, as chip_smoke.check_box_tail.
    cur6 = (torch.randn((12, 2000, 1024), generator=g, device=dev) * 0.15).to(bf)
    w7 = ((torch.rand((1024, 1024), generator=g, device=dev) * 2 - 1) / 32.0).to(bf)
    # The readout padded to 48 columns, as the wrapper pads it.
    wro = torch.nn.functional.pad((torch.rand((1024, 45), generator=g, device=dev) * 2 - 1)
                                  / 32.0, (0, 3)).to(bf)
    logits = torch.empty((2000, 45), device=dev)
    tail_counts = torch.zeros((2000, 2), dtype=torch.int32, device=dev)
    codes = torch.empty((2, 2000, 1024), dtype=torch.int16, device=dev)

    def k4_run(lib):
        fn = lib.box_tail_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        cb.check(fn(cur6.data_ptr(), w7.data_ptr(), wro.data_ptr(), logits.data_ptr(),
                    tail_counts.data_ptr(), codes[0].data_ptr(), codes[1].data_ptr(), 2000, 12,
                    1024, 45, stream), "K4")

    # K7's weight gradient: dc planes of the size K1 saves at T = 8 and
    # period maps of 1 .. T + 1, five levels.
    dcs = [(torch.randn((2, h, w, 8, 256), generator=g, device=dev) * 1e-3).to(bf)
           for h, w in levels]
    pers = [torch.randint(1, 10, (2, h, w, 256), generator=g, device=dev).to(torch.uint8)
            for h, w in levels]
    dw9 = torch.empty((9, 256, 256), device=dev)

    def k7_run(lib, i):
        n, h, w, t, c = dcs[i].shape
        s9 = k1._splits(n * h * (-(-w // 8)), k1.DW9_SPLITS)
        part9 = torch.empty((s9, 9, c, c), device=dev)
        counters = torch.zeros(18, dtype=torch.int32, device=dev)
        fn = lib.rpn_level_bwd_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        cb.check(fn(dcs[i].data_ptr(), pers[i].data_ptr(), None, wout.data_ptr(),
                    consts.data_ptr(), None, None, part9.data_ptr(), None,
                    counters.data_ptr(), dw9.data_ptr(), None, n, h, w, t, 15, s9, 1, 2,
                    stream), "K7")

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), chosen)
        for (kernel, variant, _), lib in zip(chosen, libs):
            if kernel == "K7":
                per = [chip_smoke._median_ms(lambda: k7_run(lib, i), 10)
                       for i in range(len(levels))]
                print(f"K7 weight gradient {variant}: P2..P6 " + " / ".join(f"{x:.3f}" for x in per)
                      + f" ms, five levels {sum(per):.3f} ms")
                continue
            if kernel in ("K3", "K4"):
                ms = chip_smoke._median_ms(lambda: (k3_run if kernel == "K3" else k4_run)(lib), 10)
                print(f"{kernel} {variant}: {ms:.3f} ms")
                continue
            if kernel == "K1":
                per = [chip_smoke._median_ms(lambda: k1_run(lib, f), 10) for f in feats]
                print(f"K1 {variant}: P2..P6 " + " / ".join(f"{x:.3f}" for x in per)
                      + f" ms, five levels {sum(per):.3f} ms")
                continue
            for rows in (8, 4):
                per = [chip_smoke._median_ms(lambda: k5_run(lib, i, rows), 10)
                       for i in range(len(shapes))]
                print(f"K5 {variant}, {rows}-row tiles: C2..C5 "
                      + " / ".join(f"{x:.3f}" for x in per) + f" ms, four levels "
                      f"{sum(per):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
