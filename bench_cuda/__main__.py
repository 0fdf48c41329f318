"""``python -m bench_cuda --workload NAME --seed N --seconds S --trace 0|1``:
one run of one cell of ``BENCHMARK.json`` on the card.

Needs as many CUDA devices as the cell asks for: with fewer, or none, it
exits 2 and prints no result. A run that cannot finish (a module of JAX or
of the JAX package loaded, a file missing) exits 3 and prints no result.
Otherwise the last line of standard output is the result (``harness.run``),
and the numbers compared, each with its limit, are the last lines of
standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench_cuda", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True, help="weights and inputs")
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: the per-layer metrics from a traced window")
    args = ap.parse_args(argv)

    import torch

    from bench_cuda import harness

    try:
        chips = harness.workload(harness.manifest(), args.workload)["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"bench_cuda: {args.workload} needs {chips} CUDA device(s), "
                  f"{torch.cuda.device_count()} here; no result", file=sys.stderr)
            return 2
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.RunError as e:
        print(f"bench_cuda: {e}; no result", file=sys.stderr)
        return 3
    if "batch_ms_samples" in line:
        print(f"eval_batch_ms_p95 over {line['batch_ms_samples']} batches", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
