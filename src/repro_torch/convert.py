"""Turn the reference package's parameters and caches into the port's.

The input is the reference's tree after `np.asarray` was applied to every
leaf (numpy only, so this module needs no jax). Keys, the leading period
axis and the einsum layouts are kept. bfloat16 leaves arrive as numpy
arrays of the `bfloat16` extension dtype, which torch cannot read: they go
through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree, device="cpu"):
    """Dicts and lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return _leaf(tree, device)


def caches_from_numpy(tree, device="cpu"):
    """A reference cache tree -> the port's; `index` becomes an int."""
    out = params_from_numpy({k: v for k, v in tree.items() if k != "index"},
                            device)
    out["index"] = int(np.asarray(tree["index"]))
    return out
