#!/usr/bin/env python3
"""Show on one NVIDIA GPU that the kernel checks can fail.

    python3 chip_mutants.py

For each mutant below, the script copies the repository's files into a
temporary directory, breaks one line of one CUDA source in the copy, and
runs there (a) that kernel's phase of ``chip_smoke.py`` and (b) that
kernel's card tests. Both must fail on every mutant. The mutants of
``BENCH_MUTANTS`` (of K1, K3, K4 and K7, the optimizer's step and the
joint route's gradient) run the benchmark's checks,
``python -m bench_torch --check-only`` on the cells each names, which must
exit non-zero with every such cell not correct; its controls
(``BENCH_CONTROLS``: the bf16-state route) must fail the benchmark's check
(c) against the float32 route. The mutants of the
data-parallel step (``DP_MUTANTS``: a line of a Python file of the package)
run the ``dist`` phase only, which must fail; the mutants of the training
route with trainable backbone stages (``JOINT_MUTANTS``, Python lines too)
run the ``joint`` phase and its card test, which must both fail. The script prints the
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
    ("K6: the wait on the window's full barrier at the top of the tile loop removed",
     "stem.cu", "    mbar_wait(&full[slot], (s / kStages) & 1);\n", "",
     "check_stem", "stem_kernel or stem_check_instance"),
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
    ("K3 train: the carried membrane spiking at v = 0.25 (one step early at x = 2.5)",
     "encoder_fc6.cu", "if (v - 0.25f > 0.0f) {", "if (v - 0.25f >= 0.0f) {",
     "check_encoder_fc6_train", "encoder_fc6_train or encoder_train"),
    ("fc6 wgrad: each step's spikes built from the next step's code bit",
     "encoder_fc6_wgrad.cu", "a[kk][i] = ((pair[kk][i] >> bit) & 0x10001u) * 0x3F80u;",
     "a[kk][i] = ((pair[kk][i] >> (bit + 1)) & 0x10001u) * 0x3F80u;",
     "check_encoder_fc6_train", "wgrad"),
    ("fc6 wgrad: a cotangent stage read from the ring slot before its own",
     "encoder_fc6_wgrad.cu", "desc_mn_sw128(ring + slot * kBBytes, kChunkBytes);",
     "desc_mn_sw128(ring + ((slot + kStages - 1) % kStages) * kBBytes, kChunkBytes);",
     "check_encoder_fc6_train", "wgrad"),
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

# (name, file under the package, the lines as they stand, the broken
# lines): the data-parallel step, held by chip_smoke.dist_path alone.
DP_MUTANTS = [
    ("DP: the gradient all-reduce left out (each rank steps on its own gradients)",
     "parallel/collectives.py",
     "        dist.all_reduce(flat)\n        for p, g in zip(group",
     "        for p, g in zip(group"),
    ("DP: the losses divided by the rank's own counts (no count summed over the ranks)",
     "parallel/collectives.py",
     "    if group_active():\n        dist.all_reduce(t)\n    return t",
     "    return t"),
]

# (name, file under the package, the lines as they stand, the broken
# lines): the training route with trainable backbone stages, held by
# chip_smoke.joint_path and by its card test.
JOINT_MUTANTS = [
    ("Joint: the features detached for N > 0 (no gradient reaches the backbone)",
     "models/detector.py",
     "    if not (training and tbl > 0):\n        feats = [f.detach() for f in feats]",
     "    if True:\n        feats = [f.detach() for f in feats]"),
]
JOINT_TESTS = "joint_training_step"

# Mutants that the benchmark's own checks must catch: ``python -m
# bench_torch --check-only`` on the cells named (the launch counts, the
# outputs, the float32 route's rates, head readouts, losses, gradients and
# update, a repeat) must exit non-zero in the broken tree, and every cell
# named must come out not correct. Each is a kernel mutant of MUTANTS, a
# mutant of JOINT_MUTANTS, or one of BENCH_PY_MUTANTS; named "Bench K1:
# ..." and so on.
BENCH_MUTANTS = (
    ("K1: the last chunk's steps left out of the recurrence", ("r50_rates_b2",)),
    ("K1: the last step of every chunk left out of the recurrence",
     ("r50_rates_b2", "r50_train_frozen_b2")),
    ("K3: a w6 stage read from the ring slot before its own (the spike-code GEMM)",
     ("r50_rates_b2",)),
    ("K3: the code's step bit one step late (spikes at t + 1 = p, 2p, ... moved to t + 2)",
     ("r50_rates_b2",)),
    ("K4: the readout's last step left out of the LI epilogue", ("r50_eval_b2",)),
    ("K7: the weight gradient's tap shift without its row (dy dropped)",
     ("r50_train_frozen_b2",)),
    ("K7: the reset's gate (1 - s_t) left out of the reverse step", ("r50_train_frozen_b2",)),
    ("K7: the first split's partial left out of the fixed-order sum", ("r50_train_frozen_b2",)),
    ("Train: the optimizer's step left out (every state stays as it was)",
     ("r50_train_frozen_b2", "r50_train_n3_b2")),
    ("Joint: the features detached for N > 0 (no gradient reaches the backbone)",
     ("r50_train_n3_b2",)),
)
# (name, the configuration fields replaced, the cells): controls of the
# benchmark's check (c), run on the tree as it is. A control route that
# loses precision the kernels' route keeps must fail check (c)
# ("vs_float32") on every cell named, whatever else fails with it.
BENCH_CONTROLS = (
    ("Control: the bf16-state route (the neuron states rounded to bf16)",
     {"snn_state_dtype": None}, ("r50_rates_b2", "r50_eval_b2", "mnv3_eval_b2")),
)
# (name, file under the package, the lines as they stand, the broken
# lines): Python mutants that only the benchmark's checks run.
BENCH_PY_MUTANTS = [
    ("Train: the optimizer's step left out (every state stays as it was)",
     "train/steps.py", "        optimizer.step()\n", ""),
]

# The mutants to run can be named by the kernel their description begins
# with (``python3 chip_mutants.py K8 K9``, ``DP`` for the data-parallel
# ones, ``Joint`` for the training route with trainable stages, ``Bench``
# for the benchmark's checks and controls, ``Control`` for the controls
# alone); none named means all.

PHASE = """
import torch, chip_smoke
chip_smoke.reference_numerics()
dev = torch.device("cuda:0")
chip_smoke.{phase}(dev, torch.Generator(device=dev).manual_seed(1234), [])
"""
DIST_PHASE = """
import torch, chip_smoke
chip_smoke.reference_numerics()
chip_smoke.dist_path(torch.device("cuda:0"))
"""
JOINT_PHASE = """
import torch, chip_smoke
chip_smoke.reference_numerics()
chip_smoke.joint_path(torch.device("cuda:0"))
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


def _bench_report(stdout: str, cells) -> list:
    """(report lines, whether every cell named came out not correct) of a
    benchmark run's JSON lines: per cell its failed checks with the gaps
    over their limits, then every gap it read."""
    import json

    lines = {}
    for text in stdout.splitlines():
        if text.startswith("{"):
            line = json.loads(text)
            lines[line["cell"]] = line
    out, caught = [], True
    for cell in cells:
        if cell not in lines:
            out.append(f"  bench {cell}: no JSON line (the run raised)")
            continue
        line = lines[cell]
        caught = caught and not line["correct"]
        failed = {k: {g: v for g, v in c.get("gaps", {}).items()
                      if g in c.get("tols", {}) and v > c["tols"][g]}
                  for k, c in line["checks"].items() if not c["ok"]}
        out.append(f"  bench {cell}: correct {line['correct']}, failed checks {failed}")
        every = {g: v for c in line["checks"].values() for g, v in c.get("gaps", {}).items()}
        out.append(f"  gaps {cell}: {json.dumps(every)}")
    return out, caught


def _controls(names) -> int:
    """Runs the controls named (all when ``names`` holds "Bench" or is
    empty); returns how many passed check (c)."""
    import json

    passed = 0
    for name, override, cells in BENCH_CONTROLS:
        if names and "Bench" not in names and name.split(":")[0] not in names:
            continue
        run = _run([sys.executable, "-m", "bench_torch", "--check-only", "--override",
                    json.dumps(override)] + [a for cell in cells for a in ("--cell", cell)],
                   ROOT)
        report, _ = _bench_report(run.stdout, cells)
        lines = {ln["cell"]: ln for ln in map(json.loads, (t for t in run.stdout.splitlines()
                                                             if t.startswith("{")))}
        caught = all(cell in lines and not lines[cell]["checks"]["vs_float32"]["ok"]
                     for cell in cells)
        print(f"control {name}")
        print("\n".join(report))
        if not caught:
            passed += 1
            print("  PASSED check (c)")
    return passed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 1
    survived = 0
    every = [("csrc/" + src, old, new, name, PHASE.format(phase=phase), tests)
             for name, src, old, new, phase, tests in MUTANTS] + [
        (src, old, new, name, DIST_PHASE, None) for name, src, old, new in DP_MUTANTS] + [
        (src, old, new, name, JOINT_PHASE, JOINT_TESTS) for name, src, old, new in JOINT_MUTANTS]
    sources = {name: ("csrc/" + src, old, new) for name, src, old, new, _, _ in MUTANTS}
    sources.update({name: (src, old, new) for name, src, old, new in JOINT_MUTANTS
                    + BENCH_PY_MUTANTS})
    every += [(*sources[name], "Bench " + name, None, cells) for name, cells in BENCH_MUTANTS]
    chosen = [m for m in every if not sys.argv[1:] or m[3].split(":")[0] in sys.argv[1:]
              or (m[3].startswith("Bench ") and "Bench" in sys.argv[1:])]
    for src, old, new, name, phase, tests in chosen:
        with tempfile.TemporaryDirectory() as tmp:
            tree = Path(tmp) / "tree"
            shutil.copytree(ROOT, tree, ignore=shutil.ignore_patterns(
                ".git", "_build", "__pycache__"))
            path = tree / PKG / src
            text = path.read_text()
            if text.count(old) != 1:
                print(f"chip_mutants: {src}: the line to break is not there once")
                return 1
            path.write_text(text.replace(old, new))
            limit = HANG_TIMEOUT if "hangs" in name else TIMEOUT
            if phase is None:       # the benchmark's checks on the cells named
                smoke = _run([sys.executable, "-m", "bench_torch", "--check-only"]
                             + [a for cell in tests for a in ("--cell", cell)], tree, limit)
            else:
                smoke = _run([sys.executable, "-c", phase], tree, limit)
            card = None if tests is None or phase is None else _run(
                [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider",
                 "-q", "tests/test_torch_cuda_kernels.py", "-k", tests], tree, limit)
        print(f"mutant {name}")
        if phase is None:
            report, caught = _bench_report(smoke.stdout, tests)
            print("\n".join(report))
            print(f"  bench exit {smoke.returncode}")
            if smoke.returncode == 0 or not caught:
                survived += 1
                print("  SURVIVED the benchmark's checks")
            continue
        for line in (smoke.stdout + smoke.stderr).strip().splitlines()[-6:]:
            print(f"  smoke: {line}")
        if card is None:
            print(f"  smoke exit {smoke.returncode}; no card tests")
        else:
            print(f"  smoke exit {smoke.returncode}; card tests exit {card.returncode}: "
                  f"{card.stdout.strip().splitlines()[-1] if card.stdout.strip() else ''}")
        # pytest exits 1 when tests ran and failed (5 would mean none ran);
        # -9 is a run killed at the time limit.
        if ("chip_smoke: FAILED" not in smoke.stderr and smoke.returncode != -9) \
                or (card is not None and card.returncode not in (1, -9)):
            survived += 1
            print("  SURVIVED a check")
    print(f"chip_mutants: {len(chosen) - survived} of {len(chosen)} mutants fail both checks")
    passed = _controls(sys.argv[1:])
    if passed:
        print(f"chip_mutants: {passed} control(s) passed the benchmark's check (c)")
    return 1 if survived or passed else 0


if __name__ == "__main__":
    sys.exit(main())
