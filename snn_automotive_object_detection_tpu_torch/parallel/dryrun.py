"""One data-parallel training step on n gloo processes on the CPU.

The counterpart of the JAX package's ``dryrun_multichip(n)``
(``__graft_entry__.py``): its small configuration (5 classes, T_rpn =
T_det = 2, a 128 x 256 bucket, RPN 100/50 proposals, 16 sampled RoIs,
float32, AdamW at 1e-4), one image per process, one step. Every rank must
return finite losses, the same on every rank.

    python -m snn_automotive_object_detection_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
TIMEOUT_S = 300
BUCKET = (128, 256)


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """The environment of one rank of ``world`` on this machine, as torchrun
    would set it, with two CPU threads (ranks share the machine's cores)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2")
    return env


def run_ranks(module: str, world: int, args: List[str], timeout: float = TIMEOUT_S,
              env_extra: Optional[Dict[str, str]] = None) -> List[str]:
    """``python -m module *args`` as ``world`` ranks of one gloo group on
    this machine; each must exit with 0 within ``timeout`` seconds, or all
    are killed and this raises with their output. Returns each rank's
    standard output."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              env={**_rank_env(r, world, port), **(env_extra or {})},
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            if p.returncode != 0:
                failed.append(r)
    except subprocess.TimeoutExpired:
        failed.append(f"timeout after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"{module}: ranks {failed} failed:\n" + "\n".join(
            f"----- rank {r} -----\n{o[-4000:]}" for r, o in enumerate(outs)))
    return outs


def dryrun_multiprocess(n_procs: int) -> Dict[str, float]:
    """One step on ``n_procs`` gloo ranks of one image each; returns rank
    0's losses after checking that all are finite and equal on all ranks."""
    outs = run_ranks("snn_automotive_object_detection_tpu_torch.parallel.dryrun", n_procs,
                     ["--rank-step"])
    losses = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    if any(got != losses[0] for got in losses[1:]):
        raise RuntimeError(f"the ranks' losses differ: {losses}")
    if not all(math.isfinite(v) for v in losses[0].values()):
        raise RuntimeError(f"non-finite losses: {losses[0]}")
    print(f"dryrun_multiprocess({n_procs}) losses: {losses[0]}")
    return losses[0]


def _rank_step() -> None:
    """One rank's step; prints its losses as the last line of JSON."""
    import torch

    from snn_automotive_object_detection_tpu_torch.models.factory import (
        DetectorConfig,
        init_params,
    )
    from snn_automotive_object_detection_tpu_torch.models.roi_heads import RoIConfig
    from snn_automotive_object_detection_tpu_torch.models.rpn import RPNConfig
    from snn_automotive_object_detection_tpu_torch.parallel.collectives import (
        parallel_world,
    )
    from snn_automotive_object_detection_tpu_torch.parallel.mesh import (
        init_distributed,
        replicate,
    )
    from snn_automotive_object_detection_tpu_torch.train.optim import (
        build_optimizer,
        split_trainable,
    )
    from snn_automotive_object_detection_tpu_torch.train.steps import make_train_step

    if not init_distributed("cpu"):
        raise RuntimeError("no process group: RANK and WORLD_SIZE are not set")
    rank, world = parallel_world()
    h, w = BUCKET
    config = DetectorConfig(
        num_classes=5, rpn_snn=True, detector_snn=True, t_rpn=2, t_det=2,
        min_size=h, max_size=w,
        rpn=RPNConfig(pre_nms_top_n_train=100, post_nms_top_n_train=50,
                      pre_nms_top_n_test=100, post_nms_top_n_test=50),
        roi=RoIConfig(batch_size_per_image=16, detections_per_img=10),
        compute_dtype=torch.float32)
    params = replicate(init_params(config, torch.Generator().manual_seed(0), device="cpu"))
    trainable, frozen = split_trainable(params)
    optimizer, scheduler = build_optimizer(trainable, "AdamW", 1e-4)
    # The global batch of one image per rank, drawn alike on every rank;
    # each keeps its row.
    images = torch.rand((world, h, w, 3), generator=torch.Generator().manual_seed(1))
    g = 3
    batch = {"images": images[rank:rank + 1],
             "image_sizes": torch.tensor([[h, w]]),
             "original_sizes": torch.tensor([[1024, 2048]]),
             "targets": {"boxes": torch.tensor([[[10.0, 10.0, 80.0, 60.0]] * g]),
                         "labels": torch.ones((1, g), dtype=torch.int64),
                         "valid": torch.ones((1, g), dtype=torch.bool)}}
    step = make_train_step(config, optimizer, scheduler)
    losses = step(trainable, frozen, batch, torch.Generator().manual_seed(1))
    print(json.dumps({k: float(v) for k, v in losses.items()}))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:] == ["--rank-step"]:
        _rank_step()
    else:
        dryrun_multiprocess(int(sys.argv[1]) if sys.argv[1:] else 2)
