#!/usr/bin/env python3
"""Time the redesigned kernels with parts of them switched off, on one
NVIDIA GPU.

    python3 chip_diagnose.py            # K1, K5, K3, K4, K7, K2, K6, K8 and K9
    python3 chip_diagnose.py K2 K6      # only those kernels' variants
    python3 chip_diagnose.py K9         # also K9's check on the input where it once failed
    python3 chip_diagnose.py ptxas DIR  # ptxas figures of K1, K7, K3, K4, K9, K6 against DIR's csrc/
    python3 chip_diagnose.py graphs [CELL]  # the benchmark's cell with 0 .. 5 graphed functions

Shows what limits K1, K5, K3, K4, K7's weight gradient, K2, K6, K8 and K9.
Each variant below replaces lines of ``csrc/rpn_head.cu`` (K1 and its pair
instance K8), ``csrc/fpn_level.cu`` (K5), ``csrc/spike_gemm.cuh`` (the
spike-code GEMM of K3, K4 and K9), ``csrc/rpn_head_bwd.cu`` (K7),
``csrc/roi_align.cu`` (K2) or ``csrc/stem.cu`` (K6) in a copy of ``csrc/``
in a temporary directory (the
repository is never edited). All variants build at once, one ``nvcc`` each
with the package's flags, and each is timed with CUDA events at the
flagship shapes through the kernel's C interface, so no wrapper's host work
is in the times (median of 10 single launches; K2 and K6, whose launches are
shorter, per launch over runs of 20): K1 on the five RPN levels of an image
pair at T = 8 with 15 readout channels, K5 on C2..C5 with 8-row and with
4-row tiles, K3 on x [2000, 12544] at T = 12, K4 on cur6 [12, 2000, 1024]
with 45 readout columns, K7's weight gradient alone (its C interface with
only that phase) on random dc planes and period maps of the five levels at
T = 8, K2 on 2 x 1000 boxes over P2..P5, K6 on a 2 x 768 x 1536 image pair,
K8 on K1's five levels, K9 on the periods of K3's x with w6, K4's w7 and
readout. A variant with a part switched off computes wrong numbers; only
its time means anything (the separable K2 computes RoIAlign, summed in
another order).

With ``K9`` named (or nothing), the script first draws again the input on
which K9's old count-based check failed (``kernel_checks.k9_failure_input``:
the generator state that ``chip_smoke.py``'s K9 phase drew it from, and its
plain fc6 spike count as a fingerprint) and holds K9 to its plain version
there spike by spike, as ``chip_smoke.py`` does; for the rows whose fc7
trains differ it prints the flips per step.

``ptxas DIR`` builds no variant and needs no card, only ``nvcc``: it
compiles the RPN head's two sources (``rpn_head.cu``, ``rpn_head_bwd.cu``)
the spike-code GEMM's three (``encoder_fc6.cu``, ``box_tail.cu``,
``box_head_fused.cu``) and the stem's (``stem.cu``, whose production
instance ``stem_kernel<false>`` is named as its untemplated predecessor)
from this tree's ``csrc/`` and from ``DIR`` (another
checkout's ``csrc/``) with the package's flags, and prints each entry
function's registers, barriers and spill bytes side by side. An instance
that ``DIR`` has under the same name (the T <= 16 instances: an epilogue
template at kWhole = 0 and a code pass at one plane are named as the
untemplated ones before them; K7's f32-state sweep as the sweep before its
state flag) must show the same figures, or the script exits non-zero. Each
instance for bf16 neuron states (K1's evaluation and training instances,
K8's, K7's sweep) is printed beside its f32-state instance.

``graphs [CELL]`` times the benchmark's cell CELL (``r50_eval_b2`` by
default) as ``python -m bench_torch --cell CELL`` does, six times, each in
a process of its own: with none of the five functions that evaluation
replays as CUDA graphs graphed (their originals, ``__wrapped__``, patched
in, as ``chip_smoke.eager_functions`` does), then with the first one, two,
... five of them graphed, in the order they were graphed
(``chip_smoke.GRAPHED``). It prints each run's JSON line, then a table of
images/s, the traced wall ms, launches, device busy ms and busy share a
batch, and peak memory by step; it exits non-zero if a run fails or is not
correct.

The ``as built`` timings of K1, K7 and K8 also time their instances for
bf16 neuron states in turns with the f32-state ones: K1's training
instance, K7's sweep alone, K8.
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

# K8 (the pair instance of K1's kernel, the same source): also the LIF
# recurrence over the staged currents skipped.
K1_NO_RECURRENCE = [("for (int sl = 0; sl < steps; ++sl) {", "for (int sl = 0; sl < 0; ++sl) {")]
# K9's f32 epilogues: the LIF and LI scans over the staged sums skipped.
SG_NO_F32_SCANS = [
    ("for (int t = 0; t < c.T; ++t) {\n      const float4 lo",
     "for (int t = 0; t < 0; ++t) {\n      const float4 lo"),
    ("for (int t = 0; t < c.T; ++t) {\n        const float ij",
     "for (int t = 0; t < 0; ++t) {\n        const float ij")]

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

# K2: the corner loads replaced by their addresses; the stores skipped
# (the sums stay live); every box on the finest level; and the separable
# variant, which interpolates along x first and reuses a column that the
# previous x-sample's high corner loaded (not bit-equal: other sums).
K2_NO_GATHERS = [("  return __ldg(reinterpret_cast<const uint4*>(p));",
                  "  return make_uint4((uint32_t)(uintptr_t)p, 0u, 0u, 0u);")]
K2_NO_STORES = [("      float4* dst = reinterpret_cast<float4*>(o + (int64_t)px * c + ch);",
                 "      if (acc[0] != -1.5e38f) continue;\n"
                 "      float4* dst = reinterpret_cast<float4*>(o + (int64_t)px * c + ch);")]
K2_LEVEL_0 = [("    const int lvl = (int)(k - (float)k_min);", "    const int lvl = 0;")]
# Output stores marked evict-first, so that the 100 MB of output leaves
# the L2 to the feature rows; corner loads that bypass L1.
K2_STREAM_STORES = [
    ("      dst[0] = make_float4(", "      __stcs(dst, make_float4("),
    ("      dst[1] = make_float4(", "      __stcs(dst + 1, make_float4("),
    ("acc[2] / 4.0f, acc[3] / 4.0f);", "acc[2] / 4.0f, acc[3] / 4.0f));"),
    ("acc[6] / 4.0f, acc[7] / 4.0f);", "acc[6] / 4.0f, acc[7] / 4.0f));")]
K2_NO_L1 = [("  return __ldg(reinterpret_cast<const uint4*>(p));",
             "  return __ldcg(reinterpret_cast<const uint4*>(p));")]
# Fewer registers for a fifth resident block (72 registers hold 4 blocks
# of 7 warps an SM); two bins' loads in flight at once.
K2_BLOCKS_5 = [("__launch_bounds__(kThreads)\n", "__launch_bounds__(kThreads, 5)\n")]
K2_UNROLL_2 = [("#pragma unroll 1\n    for (int px = 0; px < kOut; ++px) {",
                "#pragma unroll 2\n    for (int px = 0; px < kOut; ++px) {")]
K2_SEPARABLE = [("""#pragma unroll 1
    for (int px = 0; px < kOut; ++px) {
      uint4 v[2][2][4];""", """    float acc2[kOut][8];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const Sample& y = tab[0][2 * py + a];
      const int64_t r0 = (int64_t)y.lo * W, r1 = (int64_t)y.hi * W;
      int cached = -1;
      float c0[8], c1[8];
#pragma unroll
      for (int ix = 0; ix < kS; ++ix) {
        const Sample& x = tab[1][ix];
        float lo0[8], lo1[8], hi0[8], hi1[8];
        if (x.lo == cached) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            lo0[j] = c0[j];
            lo1[j] = c1[j];
          }
        } else {
          unpack8(ld16(f + (r0 + x.lo) * c + ch), lo0);
          unpack8(ld16(f + (r1 + x.lo) * c + ch), lo1);
        }
        unpack8(ld16(f + (r0 + x.hi) * c + ch), hi0);
        unpack8(ld16(f + (r1 + x.hi) * c + ch), hi1);
        cached = x.hi;
        const float vm = y.valid * x.valid;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c0[j] = hi0[j];
          c1[j] = hi1[j];
          const float sv = (y.h * (x.h * lo0[j] + x.l * hi0[j]) +
                            y.l * (x.h * lo1[j] + x.l * hi1[j])) * vm;
          acc2[ix / 2][j] = (a == 0 && ix % 2 == 0) ? sv : acc2[ix / 2][j] + sv;
        }
      }
    }
#pragma unroll
    for (int px = 0; px < kOut; ++px) {
      float4* dst2 = reinterpret_cast<float4*>(o + (int64_t)px * c + ch);
      dst2[0] = make_float4(acc2[px][0] / 4.0f, acc2[px][1] / 4.0f, acc2[px][2] / 4.0f,
                            acc2[px][3] / 4.0f);
      dst2[1] = make_float4(acc2[px][4] / 4.0f, acc2[px][5] / 4.0f, acc2[px][6] / 4.0f,
                            acc2[px][7] / 4.0f);
    }
#pragma unroll 1
    for (int px = 0; px < 0; ++px) {
      uint4 v[2][2][4];""")]

# K6: the products replaced by a use of A and B; the window read from the
# image by plain loads in the conversion pass (no TMA, the ring's barrier
# completed by an arrival); the old 4-row tiles; the pool or the
# conversion skipped; and, with none of those three, the A loads replaced
# by constants, the epilogue's stores and the ring's wait skipped: what is
# left is the tile loop itself (barriers, the epilogue's arithmetic,
# the prologue).
K6_NO_PRODUCTS = [("if (act[j]) wgmma_rs_n64(acc[j], a[h][j], db + h * 2);",
                   "if (act[j]) acc[j][h] += __uint_as_float(a[h][j][0] ^ a[h][j][3]) + "
                   "(float)(db & 1);")]
K6_NO_TMA = [
    ("""    mbar_expect_tx(&full[slot], kBoxBytes);
    tma_load_3d(smem + kOffRing + slot * kStageBytes, &map_img, &full[slot],
                3 * (4 * t.px0 - 5) - 1, 4 * t.py0 - 5, t.n);""",
     """    (void)t;
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(smem_u32(&full[slot]))
                 : "memory");"""),
    ("""      const float4 f0 = *reinterpret_cast<const float4*>(src);
      const float4 f1 = *reinterpret_cast<const float4*>(src + 4);
      const float4 f2 = *reinterpret_cast<const float4*>(src + 8);
      const float v[12] = {f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x, f2.y, f2.z, f2.w,
                           src[12]};""",
     """      (void)src;
      float v[12];
#pragma unroll
      for (int e = 0; e < 12; ++e) {
        const int x = 3 * ix0 + 12 * j + e;
        v[e] = (row_in && x >= 0 && x < 3 * W) ? img_g[((int64_t)t.n * H + iy) * 3 * W + x]
                                               : 0.0f;
      }"""),
    ("stem_kernel(const __grid_constant__ CUtensorMap map_img,   // img [N, H, 3 W] f32",
     "stem_kernel(const __grid_constant__ CUtensorMap map_img, const float* __restrict__ img_g,"),
    ("      map, reinterpret_cast<const bf16*>(wk), bias,",
     "      map, img, reinterpret_cast<const bf16*>(wk), bias,")]
K6_4_ROWS = [("constexpr int kTP = 8;", "constexpr int kTP = 4;")]
K6_NO_POOL = [("    for (int i = tid; i < kTP * kTQ * (kCo / 8); i += kThreads) {",
               "    for (int i = tid; i < 0; i += kThreads) {")]
K6_NO_CONVERT = [("    for (int q = tid; q < kIR * kGroups; q += kThreads) {",
                  "    for (int q = tid; q < 0; q += kThreads) {")]
K6_NO_A = [(f"a[h][j][{i}] = lds32({p});", f"a[h][j][{i}] = (uint32_t)(kk + {i});")
           for i, p in enumerate(("a_lo[j] + kk", "a_hi[j] + kk", "a_lo[j] + kk + 8",
                                  "a_hi[j] + kk + 8"))]
K6_NO_EPILOGUE = [("            *reinterpret_cast<__nv_bfloat162*>(conv_s + m * kLdc + ch) =",
                   "            if (c.x == -3.0f) "
                   "*reinterpret_cast<__nv_bfloat162*>(conv_s + m * kLdc + ch) =")]
K6_NO_WAIT = [("mbar_wait(&full[slot], (s / kStages) & 1);", "(void)full;")]


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
    ("K7", "dc stream only", K7_NO_PRODUCTS + K7_NO_A_BUILD),
    ("K2", "as built", []),
    ("K2", "no gathers", K2_NO_GATHERS),
    ("K2", "no stores", K2_NO_STORES),
    ("K2", "every box on level 0", K2_LEVEL_0),
    ("K2", "separable", K2_SEPARABLE),
    ("K2", "5 blocks an SM", K2_BLOCKS_5),
    ("K2", "two bins in flight", K2_UNROLL_2),
    ("K2", "evict-first output stores", K2_STREAM_STORES),
    ("K2", "corner loads past L1", K2_NO_L1),
    ("K6", "as built", []),
    ("K6", "no products", K6_NO_PRODUCTS),
    ("K6", "window load without TMA", K6_NO_TMA),
    ("K6", "4-row tiles", K6_4_ROWS),
    ("K6", "no pool", K6_NO_POOL),
    ("K6", "no conversion", K6_NO_CONVERT),
    ("K6", "no products, no pool, no conversion", K6_NO_PRODUCTS + K6_NO_POOL + K6_NO_CONVERT),
    ("K6", "none of the three, no A loads", K6_NO_PRODUCTS + K6_NO_POOL + K6_NO_CONVERT + K6_NO_A),
    ("K6", "none of the three, no A loads, no epilogue stores, no ring wait",
     K6_NO_PRODUCTS + K6_NO_POOL + K6_NO_CONVERT + K6_NO_A + K6_NO_EPILOGUE + K6_NO_WAIT),
    ("K8", "as built", []),
    ("K8", "no products", K1_NO_PRODUCTS),
    ("K8", "no A build", K1_NO_A_BUILD),
    ("K8", "no LIF recurrence", K1_NO_RECURRENCE),
    ("K8", "weight stream only", K1_NO_PRODUCTS + K1_NO_A_BUILD + K1_NO_RECURRENCE),
    ("K9", "as built", []),
    ("K9", "no products", SG_NO_PRODUCTS),
    ("K9", "no A build", SG_NO_A_BUILD),
    ("K9", "no f32 scans", SG_NO_F32_SCANS),
    ("K9", "weight and code stream only", SG_NO_PRODUCTS + SG_NO_A_BUILD + SG_NO_F32_SCANS)]
# (the file the replacements patch, the source built)
SOURCE = {"K1": ("rpn_head.cu", "rpn_head.cu"), "K5": ("fpn_level.cu", "fpn_level.cu"),
          "K3": ("spike_gemm.cuh", "encoder_fc6.cu"), "K4": ("spike_gemm.cuh", "box_tail.cu"),
          "K7": ("rpn_head_bwd.cu", "rpn_head_bwd.cu"), "K2": ("roi_align.cu", "roi_align.cu"),
          "K6": ("stem.cu", "stem.cu"), "K8": ("rpn_head.cu", "rpn_head.cu"),
          "K9": ("spike_gemm.cuh", "box_head_fused.cu")}


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


def _bind(lib, symbol, argtypes):
    """``symbol`` of ``lib`` with its types set, once per library."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def k9_replay(dev) -> None:
    """K9 on the input on which ``chip_smoke.check_box_head_fused`` failed
    with its old count-based check (``kernel_checks.k9_failure_input``),
    held to its plain version spike by spike as ``chip_smoke.py`` holds it;
    exits when the check fails or the input is not that one (its plain fc6
    spike count). For up to four rows whose fc7 trains differ from the
    plain tail's on K9's own fc6 spikes, the bits over and under per step."""
    import torch

    from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb
    from snn_automotive_object_detection_tpu_torch.utils import kernel_checks as kc

    cb.build_all()
    x, w6, w7, wc, wb = kc.k9_failure_input(dev)
    t = 12
    rep = kc.box_head_fused_hold(x, w6, w7, wc, wb, t)
    print(f"K9 box_head_fused on the input its old check failed on: "
          f"{kc.box_head_fused_line(rep)}")
    if rep.get("n6") != kc.K9_FAILURE_FC6_SPIKES:
        sys.exit(f"chip_diagnose: FAILED: the replayed input has {rep.get('n6')} plain fc6 "
                 f"spikes, not {kc.K9_FAILURE_FC6_SPIKES}")
    if not rep["ok"]:
        sys.exit("chip_diagnose: FAILED: K9 disagrees with its plain version on the input its "
                 "old check failed on")
    _, _, _, _, code6, code7 = k9._launch(*k9.launch_args(x, w6, w7, wc, wb), t, codes=True)
    own7 = k9.box_tail_f32_plain(k9.trains_of(code6, t), w7, wc, wb)[2]
    got7 = k9.trains_of(code7, t)
    rows = torch.nonzero((got7 != own7).any(dim=(0, 2))).flatten().tolist()
    for row in rows[:4]:
        up = (got7[:, row] > own7[:, row]).sum(1).tolist()
        down = (got7[:, row] < own7[:, row]).sum(1).tolist()
        print(f"K9 replay row {row}: fc7 spikes of K9 over / under the plain tail on K9's fc6 "
              f"spikes, per step: " + " ".join(f"{u}/{v}" for u, v in zip(up, down)))


PTXAS_SOURCES = ("rpn_head.cu", "rpn_head_bwd.cu", "encoder_fc6.cu", "box_tail.cu",
                 "box_head_fused.cu", "stem.cu")
# (bf16-state instance, its f32-state instance), as ptxas_entries names them.
STATE16_PAIRS = [
    (f"(anonymous namespace)::rpn_level_kernel<{save}, {cl}, true>",
     f"(anonymous namespace)::rpn_level_kernel<{save}, {cl}, false>")
    for save, cl in (("false", 2), ("true", 2), ("false", 4))] + [
    (f"(anonymous namespace)::sweep_kernel<{t}, true>",
     f"(anonymous namespace)::sweep_kernel<{t}>") for t in (8, 16, 32)]


def ptxas_entries(report: str) -> dict:
    """{demangled entry function: (registers, barriers, spill stores, spill
    loads)} from an ``nvcc -Xptxas -v`` report, the T <= 16 instances under
    the names of their untemplated predecessors (without a return type)."""
    import re

    raw, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            raw[name] = [0, 0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            raw[name][2:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers(?:, used (\d+) barriers)?", line)
        if m and name:
            raw[name][:2] = [int(m.group(1)), int(m.group(2) or 0)]
    names = subprocess.run(["c++filt"], input="\n".join(raw), capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out = {}
    for mangled, pretty in zip(raw, names):
        pretty = re.sub(r"(\w+)T<0>", r"\1", pretty)
        pretty = re.sub(r"(encoder_code_kernel|lif6_kernel|period_code_kernel)<1>", r"\1", pretty)
        pretty = re.sub(r"sweep_kernel<(\d+), false>", r"sweep_kernel<\1>", pretty)
        pretty = re.sub(r"stem_kernel<false>", "stem_kernel", pretty)   # K6's production instance
        # A function template's name demangles with its return type.
        pretty = re.sub(r"^void ", "", re.sub(r"\s+>", ">", pretty))
        out[pretty] = tuple(raw[mangled])
    return out


def ptxas_compare(other: Path) -> int:
    """This tree's ptxas figures of K1, K7, K3, K4, K9 and K6 against
    ``other``'s, and each bf16-state instance beside its f32-state one."""
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    def reports(csrc: Path):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen([cb._nvcc(), *cb.NVCC_FLAGS, "-o", f"{tmp}/{i}.so",
                                       str(csrc / src)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for i, src in enumerate(PTXAS_SOURCES)]
            outs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise SystemExit(f"chip_diagnose: {csrc} does not build:\n" + "\n".join(outs))
        return [ptxas_entries(o) for o in outs]

    differ = 0
    ours = reports(cb.CSRC_DIR)
    mine = {fn: fig for entries in ours for fn, fig in entries.items()}
    def entry(name):
        return next((fig for fn, fig in mine.items() if fn.startswith(name + "(")), None)

    for s16, f32 in STATE16_PAIRS:
        a, b = entry(s16), entry(f32)
        if a is None or b is None:
            raise SystemExit(f"chip_diagnose: no ptxas entry {s16 if a is None else f32}")
        print(f"ptxas bf16 states: {s16}: {a[0]} registers, spill stores {a[2]} loads {a[3]}; "
              f"f32 states: {b[0]} registers, spill stores {b[2]} loads {b[3]}")
    for src, new, old in zip(PTXAS_SOURCES, ours, reports(other)):
        for fn, fig in new.items():
            was = old.get(fn)
            same = "new" if was is None else ("same" if was == fig else "DIFFERENT")
            differ += same == "DIFFERENT"
            print(f"ptxas {src}: {fig[0]} registers, {fig[1]} barriers, spill stores "
                  f"{fig[2]} loads {fig[3]}" + ("" if was is None else f" (was {was})")
                  + f" {same}: {fn[:150]}")
        for fn in set(old) - set(new):
            differ += 1
            print(f"ptxas {src}: GONE {fn[:150]}")
    print(f"ptxas: {differ} entries differ from {other}")
    return 1 if differ else 0


def graph_steps(cell: str) -> int:
    """``graphs [CELL]``: the cell timed with the first k of the graphed
    functions graphed, k = 0 .. 5, each run a process of its own (this
    script with ``graphs CELL k``); prints every JSON line and a table."""
    import json

    import chip_smoke

    rows = []
    for k in range(len(chip_smoke.GRAPHED) + 1):
        out = subprocess.run([sys.executable, __file__, "graphs", cell, str(k)],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            print(f"chip_diagnose graphs: step {k} failed", file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
        rows.append((k, json.loads(lines[-1])))
    print("step | graphed last | images/s | wall ms a batch (traced) | launches a batch | "
          "device busy ms a batch | busy share | peak GiB | correct")
    for k, line in rows:
        layers, m = line["layers"], line["metrics"]
        last = chip_smoke.GRAPHED[k - 1][1] if k else "none"
        print(f"{k} | {last} | {m['images_per_s']['value']:.3f} | "
              f"{layers['wall_ms_per_batch']:.3f} | {layers['launches_per_batch']:.1f} | "
              f"{layers['device_busy_ms_per_batch']:.3f} | {layers['device_busy_share']:.3f} | "
              f"{m['peak_mem_gib']['value']:.4f} | {line['correct']}")
    return 0 if all(line["correct"] for _, line in rows) else 1


def _graph_step(cell: str, k: int) -> int:
    """One step of :func:`graph_steps`: ``python -m bench_torch --cell
    CELL`` with only the first ``k`` graphed functions graphed."""
    import chip_smoke
    from bench_torch.__main__ import main as bench_main

    with chip_smoke.eager_functions(chip_smoke.GRAPHED[k:]):
        return bench_main(["--cell", cell])


def main() -> int:
    import torch

    if sys.argv[1:2] == ["ptxas"]:
        return ptxas_compare(Path(sys.argv[2]))
    if sys.argv[1:2] == ["graphs"]:
        cell = sys.argv[2] if len(sys.argv) > 2 else "r50_eval_b2"
        if len(sys.argv) > 3:
            return _graph_step(cell, int(sys.argv[3]))
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
        return graph_steps(cell)
    if not torch.cuda.is_available():
        print("chip_diagnose: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    chip_smoke.reference_numerics()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if not sys.argv[1:] or "K9" in sys.argv[1:]:
        k9_replay(torch.device("cuda:0"))
    from snn_automotive_object_detection_tpu_torch.models import transform
    from snn_automotive_object_detection_tpu_torch.ops import cuda_fpn as k5
    from snn_automotive_object_detection_tpu_torch.ops import cuda_roi_align as k2
    from snn_automotive_object_detection_tpu_torch.ops import cuda_stem as k6
    from snn_automotive_object_detection_tpu_torch.snn import cuda_fc6 as k3
    from snn_automotive_object_detection_tpu_torch.snn import cuda_kernels as k9
    from snn_automotive_object_detection_tpu_torch.snn import cuda_rpn as k1
    from snn_automotive_object_detection_tpu_torch.snn import functional as snnf
    from snn_automotive_object_detection_tpu_torch.utils import cuda_build as cb

    chosen = [v for v in VARIANTS if not sys.argv[1:] or v[0] in sys.argv[1:]]

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
        fn = _bind(lib, "rpn_level_bf16", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
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
        fn = _bind(lib, "fpn_level_bf16", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
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
        fn = _bind(lib, "encoder_fc6_bf16", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
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
        fn = _bind(lib, "box_tail_bf16", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
        cb.check(fn(cur6.data_ptr(), w7.data_ptr(), wro.data_ptr(), logits.data_ptr(),
                    tail_counts.data_ptr(), codes[0].data_ptr(), codes[1].data_ptr(), None,
                    2000, 12, 1024, 45, stream), "K4")

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
        fn = _bind(lib, "rpn_level_bwd_bf16", [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
        cb.check(fn(dcs[i].data_ptr(), pers[i].data_ptr(), None, wout.data_ptr(),
                    consts.data_ptr(), None, None, part9.data_ptr(), None,
                    counters.data_ptr(), dw9.data_ptr(), None, n, h, w, t, 15, s9, 1, 2,
                    stream), "K7")

    # K2: 2 x 1000 boxes over P2..P5 as chip_smoke.check_roi_align draws
    # them (without its border boxes).
    pooled = [torch.randn((2, h, w, 256), generator=g, device=dev).to(bf) for h, w in levels[:4]]
    ctr = torch.rand((2, 1000, 2), generator=g, device=dev) * torch.tensor([1536.0, 768.0],
                                                                          device=dev)
    wh = torch.rand((2, 1000, 2), generator=g, device=dev) * 400.0 + 4.0
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1).contiguous()
    roi_out = torch.empty((2, 1000, 7, 7, 256), device=dev)
    geo = k2.geometry(tuple(levels[:4]), (768, 1536))
    k2_args = ([f.data_ptr() for f in pooled] + [pooled[0].data_ptr(), ctypes.addressof(geo),
                                                 boxes.data_ptr(), 2000, 1000, 256,
                                                 roi_out.data_ptr(), stream])

    def k2_run(lib):
        cb.check(_bind(lib, "roi_align_bf16", k2._ARGTYPES)(*k2_args), "K2")

    # K6: a flagship image pair, He-normal weights folded as the wrapper does.
    images = torch.rand((2, 768, 1536, 3), generator=g, device=dev)
    wf, sbias = k6.fold_stem_weights(
        torch.randn((7, 7, 3, 64), generator=g, device=dev) * (2.0 / (49 * 64)) ** 0.5,
        torch.rand(64, generator=g, device=dev) + 0.5,
        torch.randn(64, generator=g, device=dev) * 0.2, transform.IMAGENET_MEAN,
        transform.IMAGENET_STD)
    wk, sbias = k6.kernel_weights(wf), sbias.contiguous()
    stem_out = torch.empty((2, 192, 384, 64), dtype=bf, device=dev)

    def k6_run(lib):
        fn = _bind(lib, "stem_bf16", k6._ARGTYPES)
        cb.check(fn(images.data_ptr(), wk.data_ptr(), sbias.data_ptr(), stem_out.data_ptr(),
                    *transform.IMAGENET_MEAN, 2, 768, 1536, stream), "K6")

    # K8: K1's levels and weights. K9: the periods of K3's x, w6, K4's w7
    # and readout.
    def k8_run(lib, f):
        n, h, w, _ = f.shape
        out = torch.empty((n, h, w, 15), device=dev)
        fn = _bind(lib, "rpn_level_x2_bf16", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
        cb.check(fn(f.data_ptr(), w9_t.data_ptr(), wout.data_ptr(), consts.data_ptr(),
                    out.data_ptr(), None, n, h, w, 8, 15, stream), "K8")

    # The instances for bf16 neuron states beside the f32-state ones: K1's
    # training instance and K8 on K1's levels, K7's sweep on dc-sized
    # currents (overwritten by each run; only the time means anything).
    saves = [(torch.empty((2, h, w, 15), device=dev), torch.zeros((2, 2), dtype=torch.int64,
                                                                   device=dev),
              torch.empty((2, h, w, 256), device=dev),
              torch.zeros((2, h, w, 8, 256), dtype=bf, device=dev),
              torch.empty((2, h, w, 256), dtype=torch.uint8, device=dev)) for h, w in levels]
    cots = [torch.randn((2, h, w, 15), generator=g, device=dev) for h, w in levels]
    ssums = [torch.zeros((2, h, w, 256), device=dev) for h, w in levels]

    def k1_save_run(lib, i, s16):
        f = feats[i]
        n, h, w, _ = f.shape
        fn = _bind(lib, "rpn_level_save_s16_bf16" if s16 else "rpn_level_save_bf16",
                   [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        cb.check(fn(f.data_ptr(), w9_t.data_ptr(), wout.data_ptr(), consts.data_ptr(),
                    *[t.data_ptr() for t in saves[i]], n, h, w, 8, 15, stream), "K1")

    def k7_sweep_run(lib, i, s16):
        n, h, w, t, c = dcs[i].shape
        counters = torch.zeros(18, dtype=torch.int32, device=dev)
        fn = _bind(lib, "rpn_level_bwd_s16_bf16" if s16 else "rpn_level_bwd_bf16",
                   [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        cb.check(fn(saves[i][3].data_ptr(), None, ssums[i].data_ptr(), wout.data_ptr(),
                    consts.data_ptr(), cots[i].data_ptr(), None, None, None,
                    counters.data_ptr(), None, None, n, h, w, t, 15, 1, 1, 1, stream), "K7")

    def k8_s16_run(lib, f, s16):
        n, h, w, _ = f.shape
        out = torch.empty((n, h, w, 15), device=dev)
        fn = _bind(lib, "rpn_level_x2_s16_bf16" if s16 else "rpn_level_x2_bf16",
                   [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        cb.check(fn(f.data_ptr(), w9_t.data_ptr(), wout.data_ptr(), consts.data_ptr(),
                    out.data_ptr(), None, n, h, w, 8, 15, stream), "K8")

    def states_turns(kernel, lib):
        """The f32-state and bf16-state instance of ``kernel`` in turns."""
        run = {"K1": lambda s16: [k1_save_run(lib, i, s16) for i in range(len(levels))],
               "K7": lambda s16: [k7_sweep_run(lib, i, s16) for i in range(len(levels))],
               "K8": lambda s16: [k8_s16_run(lib, f, s16) for f in feats]}[kernel]
        f32, s16 = chip_smoke._turns(lambda: run(False), lambda: run(True))
        what = {"K1": "training instance", "K7": "sweep", "K8": "pair instance"}[kernel]
        print(f"{kernel} {what}, five levels, in turns: f32 states {f32[0]:.3f} and "
              f"{f32[1]:.3f} ms, bf16 states {s16[0]:.3f} and {s16[1]:.3f} ms")

    periods = snnf.encoder_periods(x).contiguous()
    k9_out = torch.empty((2000, 45), device=dev)
    k9_counts = torch.zeros((2000, 2), dtype=torch.int32, device=dev)
    k9_codes = [torch.empty(shape, dtype=torch.int16, device=dev)
                for shape in ((2000, 12544), (2000, 1024), (2000, 1024))]

    def k9_run(lib):
        fn = _bind(lib, "box_head_fused_bf16", k9._ARGTYPES)
        cb.check(fn(periods.data_ptr(), w6.data_ptr(), w7.data_ptr(), wro.data_ptr(),
                    k9_out.data_ptr(), k9_counts.data_ptr(), *[c.data_ptr() for c in k9_codes],
                    None, 2000, 12544, 12, 45, stream), "K9")

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp), chosen)
        for (kernel, variant, _), lib in zip(chosen, libs):
            if kernel == "K8":
                per = [chip_smoke._median_ms(lambda: k8_run(lib, f), 10) for f in feats]
                print(f"K8 {variant}: P2..P6 " + " / ".join(f"{x:.3f}" for x in per)
                      + f" ms, five levels {sum(per):.3f} ms")
                if variant == "as built":
                    states_turns("K8", lib)
                continue
            if kernel == "K9":
                ms = chip_smoke._median_ms(lambda: k9_run(lib), 10)
                print(f"K9 {variant}: {ms:.3f} ms")
                continue
            if kernel in ("K2", "K6"):
                ms = chip_smoke._loop_ms(lambda: (k2_run if kernel == "K2" else k6_run)(lib))
                print(f"{kernel} {variant}: {ms:.4f} ms a bare launch")
                continue
            if kernel == "K7":
                per = [chip_smoke._median_ms(lambda: k7_run(lib, i), 10)
                       for i in range(len(levels))]
                print(f"K7 weight gradient {variant}: P2..P6 " + " / ".join(f"{x:.3f}" for x in per)
                      + f" ms, five levels {sum(per):.3f} ms")
                if variant == "as built":
                    states_turns("K7", lib)
                continue
            if kernel in ("K3", "K4"):
                ms = chip_smoke._median_ms(lambda: (k3_run if kernel == "K3" else k4_run)(lib), 10)
                print(f"{kernel} {variant}: {ms:.3f} ms")
                continue
            if kernel == "K1":
                per = [chip_smoke._median_ms(lambda: k1_run(lib, f), 10) for f in feats]
                print(f"K1 {variant}: P2..P6 " + " / ".join(f"{x:.3f}" for x in per)
                      + f" ms, five levels {sum(per):.3f} ms")
                if variant == "as built":
                    states_turns("K1", lib)
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
