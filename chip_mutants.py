#!/usr/bin/env python3
"""Show on one NVIDIA GPU that the kernel checks can fail.

    python3 chip_mutants.py

For each mutant below, the script copies the repository's files into a
temporary directory, breaks one line of one CUDA source in the copy, and
runs there (a) that kernel's phase of ``chip_smoke.py`` and (b) that
kernel's card tests. Both must fail on every mutant; the script prints the
phase's own report (how far outside the bound the broken kernel lands) and
exits non-zero if any mutant passes a check. A run killed at its time limit
(``TIMEOUT``, or ``HANG_TIMEOUT`` for a mutant that breaks a barrier
protocol and so hangs its launch) counts as a failing check. The
repository itself is never edited.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "snn_automotive_object_detection_tpu_torch"

# The card tests that reach K7, and its bf16-state instance.
K7_TESTS = "rpn_head_bwd or train_backward or wide_readout"
K7_S16_TESTS = "rpn_head_bwd_s16 or bf16_states_backward or bf16_state_training_step"
# A run past its time limit is killed and counts as a failing check: a
# broken mbarrier protocol hangs the launch rather than giving wrong numbers.
# Mutants expected to hang ("hangs" in the description) get the short limit.
TIMEOUT, HANG_TIMEOUT = 600, 180

# (name, source under csrc/, the line as it stands, the broken line,
#  chip_smoke phase, pytest -k expression)
MUTANTS = [
    ("K5: b_lat left in the border halo (not zero outside the image)",
     "fpn_level.cu", "float v0 = 0.0f, v1 = 0.0f;",
     "float v0 = __bfloat162float(blat[ch]), v1 = __bfloat162float(blat[ch + 1]);",
     "check_fpn", "fpn_level"),
    ("K6: zero in place of the mean on taps outside the image",
     "stem.cu", "o[3 * p + ch] = in ? __float2bfloat16_rn(v[3 * p + ch]) : mean_b[ch];",
     "o[3 * p + ch] = in ? __float2bfloat16_rn(v[3 * p + ch]) : __float2bfloat16_rn(0.0f);",
     "check_stem", "stem_kernel"),
    ("K6: the mean substitution dropped at the right border (the TMA's zeros kept)",
     "stem.cu", "const bool in = row_in && ix >= 0 && ix < W;",
     "const bool in = row_in && ix >= 0;", "check_stem", "stem_kernel"),
    ("K6: a window read from the other ring stage",
     "stem.cu", "const float* st = ring + slot * (kStageBytes / 4);",
     "const float* st = ring + ((slot + 1) % kStages) * (kStageBytes / 4);",
     "check_stem", "stem_kernel"),
    ("K2: the sub-bin offset 0.25 moved to 0.5",
     "roi_align.cu", "const float sub = (i % 2 == 0) ? 0.25f : 0.75f;",
     "const float sub = (i % 2 == 0) ? 0.5f : 0.75f;", "check_roi_align", "roi_align"),
    ("K2: torchvision's validity mask dropped (samples past the border kept)",
     "roi_align.cu", "s.valid = (c >= -1.0f && c <= (float)size) ? 1.0f : 0.0f;",
     "s.valid = 1.0f;", "check_roi_align", "roi_align"),
    ("K2: the level mapper rounding where it floors",
     "roi_align.cu", "float k = floorf(4.0f + log2f(sqrtf(area) / 224.0f) + 1e-6f);",
     "float k = rintf(4.0f + log2f(sqrtf(area) / 224.0f) + 1e-6f);", "check_roi_align",
     "roi_align"),
    ("K2: the level mapper's upper clamp one level low (only boxes of 448 pixels and up move)",
     "roi_align.cu", "k = fminf(fmaxf(k, (float)k_min), (float)k_max);",
     "k = fminf(fmaxf(k, (float)k_min), (float)(k_max - 1));", "check_roi_align", "roi_align"),
    ("K5: P rounded once (the conv sum not rounded before the bias add), even channels",
     "fpn_level.cu",
     "o.x = __float2bfloat16_rn(bf16_round(acc[4 * j + 2 * h]) + __bfloat162float(bout[ch]));",
     "o.x = __float2bfloat16_rn(acc[4 * j + 2 * h] + __bfloat162float(bout[ch]));",
     "check_fpn", "fpn_level"),
    ("K5: the merged map's border mask dropped (halo pixels outside the image kept)",
     "fpn_level.cu", "const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;",
     "const bool inside = true;", "check_fpn", "fpn_level"),
    ("K5: a conv weight stage read from the ring slot before its own",
     "fpn_level.cu",
     "const uint64_t db = desc_sw128(ring + slot * kSlotBytes + ch0 * kConvK * 2);",
     "const uint64_t db = desc_sw128(ring + ((slot + kStages - 1) % kStages) * kSlotBytes"
     " + ch0 * kConvK * 2);", "check_fpn", "fpn_level"),
    ("K1: the last chunk's steps left out of the recurrence",
     "rpn_head.cu", "const int steps = min(kChunk, T - chunk * kChunk);",
     "const int steps = chunk + 1 < n_chunks ? min(kChunk, T - chunk * kChunk) : 0;",
     "check_rpn_head", "test_rpn_head_kernel_matches_plain"),
    ("K1: the last step of every chunk left out of the recurrence",
     "rpn_head.cu", "for (int sl = 0; sl < steps; ++sl) {",
     "for (int sl = 0; sl < steps - 1; ++sl) {",
     "check_rpn_head", "test_rpn_head_kernel_matches_plain"),
    ("K1: a weight stage read from the ring slot before its own",
     "rpn_head.cu", "const uint64_t db = desc_sw128(ring + slot * kSlotBytes);",
     "const uint64_t db = desc_sw128(ring + ((slot + kStages - 1) % kStages) * kSlotBytes);",
     "check_rpn_head", "test_rpn_head_kernel_matches_plain"),
    ("K7: the last reverse step (t = 0) left out of the sweep",
     "rpn_head_bwd.cu", "for (int t = kTMax - 1; t >= 0; --t) {",
     "for (int t = kTMax - 1; t >= 1; --t) {", "check_rpn_bwd", K7_TESTS),
    ("K7: the reset's gate (1 - s_t) left out of the reverse step",
     "rpn_head_bwd.cu", "const float keep = (u > 0.0f) ? 0.0f : 1.0f;     // 1 - s_t",
     "const float keep = 1.0f;", "check_rpn_bwd", K7_TESTS),
    ("K7: the weight gradient's spikes shifted against the tap (x mirrored)",
     "rpn_head_bwd.cu", "x0 + dx, y + dy, n);", "x0 - dx, y + dy, n);",
     "check_rpn_bwd", K7_TESTS),
    ("K7: the first split's partial left out of the fixed-order sum",
     "rpn_head_bwd.cu", "for (int sp = 0; sp < S; ++sp) {", "for (int sp = 1; sp < S; ++sp) {",
     "check_rpn_bwd", K7_TESTS),
    ("K7: the weight gradient's tap shift without its row (dy dropped)",
     "rpn_head_bwd.cu", "x0 + dx, y + dy, n);", "x0 + dx, y, n);",
     "check_rpn_bwd", K7_TESTS),
    ("K7: the sweep's gw without the last readout channel",
     "rpn_head_bwd.cu", "for (int j = 0; j < n_out; ++j) {\n      const float gv",
     "for (int j = 0; j < n_out - 1; ++j) {\n      const float gv",
     "check_rpn_bwd", K7_TESTS),
    ("K7: K1's training instance stores each chunk's currents one step off (rotated)",
     "rpn_head.cu", "* T + chunk * kChunk + sl) * kC +",
     "* T + chunk * kChunk + (sl + 1) % steps) * kC +",
     "check_rpn_bwd", K7_TESTS + " or rpn_head_kernel_matches_plain"),
    ("K8: a block's quarter of a weight stage loaded from output channel rank x 32, not "
     "rank x 64 (the pair instance only)",
     "rpn_head.cu", "(c / 4) * kC + rank * (kC / kCl));",
     "(c / 4) * kC + rank * (kCl == 4 ? 32 : kC / kCl));", "check_rpn_x2", "rpn_head_x2"),
    ("K8: the pair's second image reading the first image's periods (the pair instance only)",
     "rpn_head.cu", "feat + (((int64_t)n * H + gy) * W + gx) * kC + ch);",
     "feat + (((int64_t)(kCl == 4 ? n & ~1 : n) * H + gy) * W + gx) * kC + ch);",
     "check_rpn_x2", "rpn_head_x2"),
    ("K8: a block's quarter multicast into the ring slot after its own (the pair instance "
     "only)",
     "rpn_head.cu",
     "tma_load_2d_multicast(ring + slot * kSlotBytes + rank * (kSlotBytes / kCl), &map_w9,",
     "tma_load_2d_multicast(ring + (kCl == 4 ? (slot + 1) % kStages : slot) * kSlotBytes"
     " + rank * (kSlotBytes / kCl), &map_w9,", "check_rpn_x2", "rpn_head_x2"),
    ("K9: the f32 epilogue's sums rounded to bf16 before the LIF and LI scans",
     "spike_gemm.cuh",
     "s.x = acc[j][4 * q + 2 * h];\n          s.y = acc[j][4 * q + 2 * h + 1];",
     "s.x = __bfloat162float(__float2bfloat16_rn(acc[j][4 * q + 2 * h]));\n"
     "          s.y = __bfloat162float(__float2bfloat16_rn(acc[j][4 * q + 2 * h + 1]));",
     "check_box_head_fused", "box_head_fused"),
    ("K9: the last step left out of the f32 LIF scan (fc6 and fc7)",
     "spike_gemm.cuh", "for (int t = 0; t < c.T; ++t) {\n      const float4 lo",
     "for (int t = 0; t < c.T - 1; ++t) {\n      const float4 lo",
     "check_box_head_fused", "box_head_fused"),
    ("K9: one code bit shifted (the encoder's spikes at t + 1 = p, 2p, ... moved to t + 2)",
     "box_head_fused.cu", "bits |= 1u << (k - 1 - 16 * h);", "bits |= 1u << (k - 16 * h);",
     "check_box_head_fused", "box_head_fused"),
    ("K9: the GEMM pass of the third code plane reading the second (steps 32-47 lost)",
     "spike_gemm.cuh",
     "const void* plane = static_cast<const uint16_t*>(codes) + (int64_t)h * R * K;",
     "const void* plane = static_cast<const uint16_t*>(codes) + (int64_t)(h == 2 ? 1 : h) * R * K;",
     "check_box_head_fused", "box_head_fused"),
    ("K1 bf16 states: the decayed membrane v not rounded to bf16",
     "rpn_head_common.cuh", "vd = bf16r(v + bf16r(kTauMem16 * bf16r(cu - v)));",
     "vd = v + bf16r(kTauMem16 * bf16r(cu - v));", "check_rpn_s16", "rpn_head_s16"),
    ("K1 bf16 states: the threshold left at f32(0.1), not rounded to bf16",
     "rpn_head_common.cuh", "const bool s = (vd - kVth16) > 0.0f;",
     "const bool s = (vd - 0.1f) > 0.0f;", "check_rpn_s16", "rpn_head_s16"),
    ("K7 bf16 states: the rerun on lif_element, with f32 states",
     "rpn_head_bwd.cu",
     "rpn::lif_element_s16(__bfloat162float(c4[e]), li[t], v[e], cu[e], ss[e], vd[t][e]);",
     "rpn::lif_element(__bfloat162float(c4[e]), li[t], v[e], cu[e], ss[e], vd[t][e]);",
     "check_rpn_s16_train", K7_S16_TESTS),
    ("K7 bf16 states: the reverse sweep's threshold left at f32(0.1), not bf16(0.1)",
     "rpn_head_bwd.cu", "const float u = vd[t][e] - (kS16 ? rpn::kVth16 : 0.1f);",
     "const float u = vd[t][e] - 0.1f;", "check_rpn_s16_train", K7_S16_TESTS),
    ("K1 bf16 states: the training instance's currents not rounded to bf16 (truncated: the "
     "f32 sums' upper halves), even channels",
     "rpn_head.cu", "o.x = __float2bfloat16_rn(acc[4 * j + 2 * h]);",
     "o.x = kSave && kS16 ? __float2bfloat16_rz(acc[4 * j + 2 * h])"
     " : __float2bfloat16_rn(acc[4 * j + 2 * h]);", "check_rpn_s16_train",
     K7_S16_TESTS + " or rpn_head_s16_kernel"),
    ("K8 bf16 states: the pair instance launched without kS16 (f32 states)",
     "rpn_head.cu", "return launch_level<false, kPairCluster, true>(",
     "return launch_level<false, kPairCluster, false>(", "check_rpn_x2_s16", "x2_s16"),
    ("K8: one block's bit dropped from the pair's multicast mask (the launch hangs; killed)",
     "rpn_head.cu", "&full[slot], (uint16_t)((1 << kCl) - 1), (c % 4) * kK,",
     "&full[slot], (uint16_t)(kCl == 4 ? 0x7 : (1 << kCl) - 1), (c % 4) * kK,",
     "check_rpn_x2", "rpn_head_x2"),
    ("K9: the last step left out of the f32 LI readout scan",
     "spike_gemm.cuh", "for (int t = 0; t < c.T; ++t) {\n        const float ij",
     "for (int t = 0; t < c.T - 1; ++t) {\n        const float ij",
     "check_box_head_fused", "box_head_fused"),
    ("K3: a w6 stage read from the ring slot before its own (the spike-code GEMM)",
     "spike_gemm.cuh", "const uint64_t db = desc_mn_sw128(base, RingT::kChunkBytes);",
     "const uint64_t db = desc_mn_sw128(ring + ((slot + kStages - 1) % kStages) * "
     "RingT::kSlotBytes, RingT::kChunkBytes);", "check_encoder_fc6", "encoder_fc6"),
    ("K3: the code's step bit one step late (spikes at t + 1 = p, 2p, ... moved to t + 2)",
     "encoder_fc6.cu", "for (int k = p; k <= T; k += p) bits |= 1u << (k - 1);",
     "for (int k = p; k <= T; k += p) bits |= 1u << k;", "check_encoder_fc6", "encoder_fc6"),
    ("K4: LIF6's last step left out of the scan",
     "box_tail.cu", "        if (t0 + t < T) {\n          const bf16* cv",
     "        if (t0 + t < T - 1) {\n          const bf16* cv", "check_box_tail", "box_tail"),
    ("K4: LIF7's last step left out of the fc7 epilogue",
     "spike_gemm.cuh", "for (int t = 0; t < c.T; ++t) {\n      const uint4 raw",
     "for (int t = 0; t < c.T - 1; ++t) {\n      const uint4 raw", "check_box_tail", "box_tail"),
    ("K4: the readout's last step left out of the LI epilogue",
     "spike_gemm.cuh", "for (int t = 0; t < c.T; ++t) {\n        const float cur",
     "for (int t = 0; t < c.T - 1; ++t) {\n        const float cur", "check_box_tail",
     "box_tail"),
] + [(f"{k}: code bits 16-31 dropped (the second GEMM pass reads the first code plane)",
      "spike_gemm.cuh",
      "const void* plane = static_cast<const uint16_t*>(codes) + (int64_t)h * R * K;",
      "const void* plane = static_cast<const uint16_t*>(codes) + (int64_t)(h == 1 ? 0 : h) * R * K;",
      phase, tests)
     for k, phase, tests in (("K3", "check_encoder_fc6", "encoder_fc6"),
                             ("K4", "check_box_tail", "box_tail"),
                             ("K9", "check_box_head_fused", "box_head_fused"))] + [
    (f"{k}: the LIF states of steps 0-15 not carried (the second plane starts from zero)",
     "spike_gemm.cuh", "const float* si) {\n#pragma unroll",
     "const float* si) {\n  return;\n#pragma unroll", phase, tests)
    for k, phase, tests in (("K4", "check_box_tail", "box_tail"),
                            ("K9", "check_box_head_fused", "box_head_fused"))]

# The mutants to run can be named by the kernel their description begins
# with (``python3 chip_mutants.py K8 K9``); none named means all.

PHASE = """
import torch, chip_smoke
chip_smoke.reference_numerics()
dev = torch.device("cuda:0")
chip_smoke.{phase}(dev, torch.Generator(device=dev).manual_seed(1234), [])
"""


def _run(cmd, cwd, timeout=TIMEOUT):
    """``cmd`` in ``cwd``; a run past ``timeout`` seconds is killed and
    reported as exit code -9 with what it printed so far."""
    try:
        return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        def text(b):
            return b.decode(errors="replace") if isinstance(b, bytes) else (b or "")
        return subprocess.CompletedProcess(cmd, -9, text(e.stdout), text(e.stderr)
                                           + f"\nkilled after {timeout} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 1
    survived = 0
    chosen = [m for m in MUTANTS if not sys.argv[1:] or m[0].split(":")[0] in sys.argv[1:]]
    for name, src, old, new, phase, tests in chosen:
        with tempfile.TemporaryDirectory() as tmp:
            tree = Path(tmp) / "tree"
            shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "_build", "__pycache__"))
            path = tree / PKG / "csrc" / src
            text = path.read_text()
            if text.count(old) != 1:
                print(f"chip_mutants: {src}: the line to break is not there once")
                return 1
            path.write_text(text.replace(old, new))
            limit = HANG_TIMEOUT if "hangs" in name else TIMEOUT
            smoke = _run([sys.executable, "-c", PHASE.format(phase=phase)], tree, limit)
            card = _run([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                         "-q", "tests/test_torch_cuda_kernels.py", "-k", tests], tree, limit)
        print(f"mutant {name}")
        for line in (smoke.stdout + smoke.stderr).strip().splitlines()[-6:]:
            print(f"  smoke: {line}")
        print(f"  smoke exit {smoke.returncode}; card tests exit {card.returncode}: "
              f"{card.stdout.strip().splitlines()[-1] if card.stdout.strip() else ''}")
        # pytest exits 1 when tests ran and failed (5 would mean none ran);
        # -9 is a run killed at the time limit.
        if ("chip_smoke: FAILED" not in smoke.stderr and smoke.returncode != -9) \
                or card.returncode not in (1, -9):
            survived += 1
            print("  SURVIVED a check")
    print(f"chip_mutants: {len(chosen) - survived} of {len(chosen)} mutants fail both checks")
    return 1 if survived else 0


if __name__ == "__main__":
    sys.exit(main())
