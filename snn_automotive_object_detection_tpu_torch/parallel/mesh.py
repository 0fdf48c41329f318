"""Process-group start-up, the rank's device and replicated parameters.

Port of ``snn_automotive_object_detection_tpu/parallel/mesh.py`` onto
``torch.distributed``. The environment is read as the reference read it
(its utils.py:268-312): torchrun's ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``, or SLURM's ``SLURM_NTASKS``, ``SLURM_PROCID`` and
``SLURM_LOCALID``; the rendezvous is ``MASTER_ADDR``:``MASTER_PORT``
(``env://``). The backend is NCCL between cards and gloo on the CPU; a
caller may ask for gloo on cards (two ranks on one card, which NCCL
refuses).

The JAX package's ``data_parallel_mesh`` and ``shard_batch`` have no
counterpart: each rank's loader yields only its own rows
(``data/loader.DetectionLoader(shard=(rank, world))``), and the training
step sums the gradients over the ranks (``train/steps.py``).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from snn_automotive_object_detection_tpu_torch.utils.weights import tree_leaves


def group_active() -> bool:
    """True while a process group is up (a group of one rank included)."""
    return dist.is_available() and dist.is_initialized()


def _env_world() -> Tuple[int, int, int]:
    """(world size, rank, local rank) from torchrun's variables, else from
    SLURM's; (1, 0, 0) when neither launcher set them."""
    env = os.environ
    if "WORLD_SIZE" in env:
        return int(env["WORLD_SIZE"]), int(env.get("RANK", 0)), int(env.get("LOCAL_RANK", 0))
    if "SLURM_NTASKS" in env:
        return (int(env["SLURM_NTASKS"]), int(env.get("SLURM_PROCID", 0)),
                int(env.get("SLURM_LOCALID", 0)))
    return 1, 0, 0


def init_distributed(device: str = "cuda", backend: Optional[str] = None) -> bool:
    """Start this process's group from the environment; True when it has
    more than one rank. With one process it does nothing and returns False;
    a second call does nothing either (a test may start the group and then
    call a CLI's ``main``, which calls this again).

    On ``device`` "cuda" the rank's card is ``cuda:<local rank>``, made the
    current device before anything touches it; the backend is NCCL unless
    ``backend`` names another (gloo). On the CPU it is gloo."""
    if group_active():
        return dist.get_world_size() > 1
    world, rank, local = _env_world()
    if world <= 1:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} has no card: this machine has "
                               f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return True


def rank_device(device) -> torch.device:
    """The device this rank runs on: for "cuda" with a group up, the card
    :func:`init_distributed` made current; otherwise ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and group_active():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def is_main_process() -> bool:
    """Rank 0, or the only process: the rank that writes shared files
    (the reference's save_on_master, its utils.py:223-265)."""
    return not group_active() or dist.get_rank() == 0


def replicate(tree: Any) -> Any:
    """Every leaf of ``tree`` overwritten in place with rank 0's values,
    so that all ranks start from rank 0's weights; the tree itself is
    returned. Nothing happens without a process group."""
    if group_active():
        for leaf in tree_leaves(tree):
            dist.broadcast(leaf.detach(), src=0)
    return tree
