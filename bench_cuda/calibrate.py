"""``python -m bench_cuda.calibrate --workload NAME --seeds A B ...
[--control-seeds C D ...]``: the readings that a cell's limits are set
from, every seed in one process on the card.

For each seed it makes one run of the cell with the shortest window that
still holds the judged batches (``harness.run``), and prints its readings
as one JSON line (``"route": "program"``). For each control seed of an
evaluation cell it also reads:

  * ``"control"``: the reference itself in the program's place, computed in
    the precision below the configuration's (fp8 operands for its bf16
    compute, bf16 neuron states for its float32 ones; ``model.CONTROL``),
    which must come out not correct;
  * ``"bf16_states"``: the program's own route with bf16 neuron states
    (``snn_state_dtype`` null), the step that would tempt a later change.

For each control seed of a training cell it reads the program's own
bf16-state route, its control, and the planted fault of half the batch
left out (``train.half_batch``), on more than one card also the exchange
of gradients left out (``train.no_exchange``); the fault of a step that
leaves the state unchanged reads 1 by the change's measure and needs no
run.

A limit lies above the largest program reading over a dozen seeds and
below the smallest control or fault reading (``PERF.md`` section 2).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench_cuda.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", help="also append each line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_cuda.calibrate: no CUDA device", file=sys.stderr)
        return 2

    from bench_cuda import harness
    from bench_cuda import weights
    from bench_cuda.reference import model as ref

    device = None
    man = harness.manifest()
    w, cfg, mix, _ = harness.cell_files(man, args.workload)

    def emit(route, seed, line, t0):
        rec = {"workload": args.workload, "route": route, "seed": seed,
               "correct": line["correct"], "failed": line["failed"],
               "readings": line["readings"],
               "seconds": time.perf_counter() - t0}
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in args.seeds:
        t0 = time.perf_counter()
        emit("program", seed, harness.run(args.workload, seed, 0.0, False, t0, device, man), t0)
    for seed in args.control_seeds:
        if mix["mode"] == "train":
            t0 = time.perf_counter()
            emit("bf16_states", seed, harness.run(
                args.workload, seed, 0.0, False, t0, device, man,
                overrides={"config": {"snn_state_dtype": None}}), t0)
            for fault in ("half_batch", "no_exchange") if w["chips"] > 1 else ("half_batch",):
                t0 = time.perf_counter()
                emit(fault, seed, harness.run(args.workload, seed, 0.0, False, t0, device, man,
                                              fault=fault), t0)
            continue
        sd = weights.make_state_dict(cfg, seed, "cuda")

        def control(params, batch, pcfg):
            with torch.no_grad(), ref.float32_matmuls():
                return ref.forward(sd, cfg, batch["images"], ref.CONTROL), {}

        def control_levels(params, images, pcfg):
            with torch.no_grad(), ref.float32_matmuls():
                return [f.permute(0, 2, 3, 1)
                        for f in ref.backbone_features(sd, cfg, images, ref.CONTROL)]

        t0 = time.perf_counter()
        emit("control", seed, harness.run(args.workload, seed, 0.0, False, t0, device, man,
                                          entry=control, features=control_levels), t0)
        del sd
        t0 = time.perf_counter()
        emit("bf16_states", seed, harness.run(args.workload, seed, 0.0, False, t0, device, man,
                                              overrides={"config": {"snn_state_dtype": None}}),
             t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
