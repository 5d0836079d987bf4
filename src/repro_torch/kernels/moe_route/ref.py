"""Plain PyTorch version of the MoE route's capacity positions: the
kernel's plain version and the form the CPU runs.

`route_positions_ref` is the one-hot cumsum that `models/layers.py::
_moe_route` computed before the kernel (the reference's `_moe_route`,
`repro/models/layers.py`, counts with `jnp.cumsum` the same way).
"""
import torch
import torch.nn.functional as F


def route_positions_ref(expert_ids, num_experts, with_counts=False):
    """expert_ids (N, K) int64 -> (pos (N, K) int64, counts (K, E) int64
    or None): each (token, k) choice's position within its expert, counted
    in (k-major, token) order, and, with `with_counts`, each rank k's
    choices by expert."""
    N, K = expert_ids.shape
    E = num_experts
    onehot = F.one_hot(expert_ids, E)                             # (N,K,E)
    flat = onehot.transpose(0, 1).reshape(K * N, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat                   # (K*N,E)
    pos = (pos_flat.reshape(K, N, E).transpose(0, 1) * onehot).sum(-1)
    counts = flat.reshape(K, N, E).sum(1) if with_counts else None
    return pos, counts
