"""Weight bridge: a JAX parameter tree, as numpy arrays, into the port.

The port keeps the JAX package's parameter layouts (HWIO convs, [in, out]
linears, RoI features flattened as (7, 7, C) so fc6 rows carry over
unpermuted, depthwise convs as [k, k, 1, C]), so conversion is a
leaf-for-leaf copy of the same nested dicts and lists, whatever keys a
block has (a MobileNet block's optional ``expand`` and ``se``). Convert a JAX tree with ``jax.tree.map(np.asarray, tree)``
first; this module itself imports no JAX. :func:`to_numpy_tree` goes the
other way (parameters after an update, or their gradients), so that both
can be held against the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from snn_automotive_object_detection_tpu_torch.utils.constants import resolve_device


def from_numpy_tree(tree: Any, device=None, dtype=torch.float32) -> Any:
    """Same nesting, each numpy leaf a torch tensor of ``dtype`` on
    ``device``; None means the CUDA device and raises where there is none."""
    device = resolve_device(device, "from_numpy_tree")
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    return torch.tensor(np.array(tree), dtype=dtype, device=device)


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"a/b/0/w": leaf} for every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict/list tree, in :func:`flatten_tree`'s order."""
    return list(flatten_tree(tree).values())


def to_numpy_tree(tree: Any, grads: bool = False) -> Any:
    """Same nesting, each tensor leaf a float numpy array on the host; with
    ``grads`` the leaves' ``.grad`` (zeros where a leaf has none)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v, grads) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v, grads) for v in tree)
    if grads:
        tree = torch.zeros_like(tree) if tree.grad is None else tree.grad
    return tree.detach().float().cpu().numpy()
