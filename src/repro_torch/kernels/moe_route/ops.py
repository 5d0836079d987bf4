"""The MoE route's capacity positions: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors.

The reference has no kernel for them (`repro/models/layers.py::
_moe_route` runs `jnp.cumsum` over a one-hot), so this one replaces none.
It takes the router's top-k ids and returns the same int64 positions as
the plain form, bit for bit (csrc/moe_route.cu); the positions take no
gradient. The wrapper plans the kernel's blocks: tiles of TILE choices,
at most MAX_BLOCKS blocks of whole tiles, and a second launch, with a
(blocks, E) int32 scratch, only where there is more than one block.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.moe_route.ref import route_positions_ref

_NAME = "moe_route"
TILE = 1024               # choices a tile (csrc/moe_route.cu)
MAX_BLOCKS = 264          # blocks a call
MAX_EXPERTS = 1024        # the kernel's MAX_E
# moe_route_positions(ids, pos, counts, hist, N, K, E, blocks, span,
# stream) in csrc/moe_route.cu
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_void_p])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(_NAME)
    lib.moe_route_positions.argtypes = ARGTYPES
    lib.moe_route_positions.restype = ctypes.c_int
    return lib


def plan(total: int) -> tuple[int, int]:
    """(blocks, span) for `total` choices: spans of whole tiles, at most
    MAX_BLOCKS of them, none empty."""
    tiles = -(-total // TILE)
    span = -(-tiles // min(tiles, MAX_BLOCKS)) * TILE
    return -(-total // span), span


def _launch_kernel(expert_ids, num_experts, with_counts):
    _launch.check_cuda_inputs(_NAME, expert_ids=expert_ids)
    if expert_ids.dtype != torch.int64:
        raise TypeError(f"{_NAME}: expert_ids must be int64, not "
                        f"{expert_ids.dtype}")
    if expert_ids.dim() != 2:
        raise ValueError(f"{_NAME}: expert_ids must be (N, K), not "
                         f"{tuple(expert_ids.shape)}")
    N, K = expert_ids.shape
    E = num_experts
    if not 0 < E <= MAX_EXPERTS:
        raise ValueError(f"{_NAME}: {E} experts, the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if not 0 < N * K < 2 ** 31 or (with_counts and K * E >= 2 ** 31):
        raise ValueError(f"{_NAME}: {N} x {K} choices, the kernel takes 1 "
                         f"to 2^31 - 1")
    dev = expert_ids.device
    pos = torch.empty((N, K), dtype=torch.int64, device=dev)
    counts = (torch.zeros((K, E), dtype=torch.int64, device=dev)
              if with_counts else None)
    blocks, span = plan(N * K)
    hist = (torch.empty((blocks, E), dtype=torch.int32, device=dev)
            if blocks > 1 else None)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.moe_route_positions(
            expert_ids.data_ptr(), pos.data_ptr(),
            None if counts is None else counts.data_ptr(),
            None if hist is None else hist.data_ptr(), N, K, E, blocks,
            span, _launch.stream_handle(expert_ids))
    _launch.raise_on_error(_NAME, err, lib, "moe_route_error_string")
    route_positions.launches += 1
    return pos, counts


def route_positions(expert_ids, num_experts, with_counts=False):
    """expert_ids (N, K) int64, the router's top-k -> (pos (N, K) int64,
    counts (K, E) int64 or None): each (token, k) choice's position within
    its expert, counted in (k-major, token) order, and, with
    `with_counts`, each rank k's choices by expert.

    CPU tensors go through `route_positions_ref`; CUDA tensors launch the
    kernel (contiguous int64 ids, E <= MAX_EXPERTS, 0 < N K < 2^31) or
    raise.
    Both give the same bits.
    """
    if expert_ids.device.type == "cpu":
        return route_positions_ref(expert_ids, num_experts, with_counts)
    return _launch_kernel(expert_ids, num_experts, with_counts)


route_positions.launches = 0
