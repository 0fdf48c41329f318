"""Weight bridge: a JAX parameter tree, as numpy arrays, into the port.

The port keeps the JAX package's parameter layouts (HWIO convs, [in, out]
linears, RoI features flattened as (7, 7, C) so fc6 rows carry over
unpermuted), so conversion is a leaf-for-leaf copy of the same nested
dicts and lists. Convert a JAX tree with ``jax.tree.map(np.asarray, tree)``
first; this module itself imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def from_numpy_tree(tree: Any, device=None, dtype=torch.float32) -> Any:
    """Same nesting, each numpy leaf a torch tensor of ``dtype``."""
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
