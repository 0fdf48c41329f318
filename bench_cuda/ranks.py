"""The ranks of a cell on more than one card, as ``torchrun`` starts them.

The process that ``python -m bench_cuda`` starts is rank 0: it spawns ranks
1 to W - 1 as ``python -m bench_cuda.ranks`` with torchrun's variables
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
sets them in its own environment, and every rank starts its process group
through the port's ``parallel/mesh.init_distributed``: NCCL between cards,
one card a rank (``cuda:<LOCAL_RANK>``), gloo on the CPU, where the tests
run four ranks. Only rank 0 prints a result; it waits for every other rank
to end, and ends any that has not within ``JOIN_S`` seconds of its own end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from contextlib import contextmanager  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

JOIN_S = 120.0
MODULE = "bench_cuda.ranks"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    return {"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


@contextmanager
def group_of(world: int, args: List[str], repo):
    """Ranks 1 to ``world`` - 1 running ``python -m bench_cuda.ranks
    *args``, this process's environment made rank 0's while the block runs.
    On leaving, waits for them (``JOIN_S`` at most), ends those left, and
    raises ``RunError`` with the output of any that failed."""
    from bench_cuda.harness import RunError

    port = _free_port()
    keys = list(_rank_env(0, world, port)) + ["NCCL_SOCKET_IFNAME"]
    saved = {k: os.environ.get(k) for k in keys}
    base = {**os.environ, "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo"),
            "PYTHONPATH": str(repo), "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "2")}
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(1, world)]
    procs = [subprocess.Popen([sys.executable, "-m", MODULE, *args],
                              env={**base, **_rank_env(r, world, port)}, cwd=repo,
                              stdout=subprocess.DEVNULL, stderr=log)
             for r, log in zip(range(1, world), logs)]
    os.environ.update(_rank_env(0, world, port), NCCL_SOCKET_IFNAME=base["NCCL_SOCKET_IFNAME"])
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        deadline = time.monotonic() + JOIN_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        failed = []
        for r, (p, log) in enumerate(zip(procs, logs), start=1):
            if p.returncode != 0:
                log.seek(0)
                failed.append(f"rank {r} exited {p.returncode}:\n{log.read()[-3000:]}")
            log.close()
        if failed and sys.exc_info()[0] is None:
            raise RunError("\n".join(failed))
        for text in failed:
            print(text, file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> int:
    """One rank other than 0: the cell's run on this rank, no result."""
    ap = argparse.ArgumentParser(prog=f"python -m {MODULE}")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", type=json.loads, default={})
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    from bench_cuda import harness

    try:
        harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_START,
                    device=None if args.device == "cuda" else args.device,
                    overrides=args.overrides, fault=args.fault)
    except harness.RunError as e:
        print(f"{MODULE}: {e}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
