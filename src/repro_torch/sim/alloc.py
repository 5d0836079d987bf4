"""Max-min water-filling over a CSR flow -> resource incidence, on the card
(twin of `repro.sim.alloc.vector_water_fill_jit`).

`vector_water_fill` is a copy of the reference's numpy allocator, the
plain version. `vector_water_fill_torch` runs the same bottleneck-freeze
rounds as torch ops on a device, float64, and returns bitwise the same
rates, as the reference's jit kernel does:

  - fair shares by IEEE division (a dead resource divides to inf, or nan
    for 0/0);
  - a selection min that skips the nans;
  - tie groups by exact float equality;
  - the capacity update of `np.subtract.at`, one rounded `rem - m` per
    pinned hold (never a fused k*m), then `np.maximum(rem, 0.0)`: one
    `index_add_` of -m per hold (`subtract_holds_`).

It needs no power-of-two padding (eager PyTorch does not recompile per
shape) and never falls back to numpy: it runs on the card unless asked
for the CPU. The reference's `ArrayCore` takes the jit solver by name;
the port imports nothing of `repro`, so a caller that wants this solver
there puts it in place of `repro.sim.alloc.vector_water_fill_jit`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def vector_water_fill(indptr: np.ndarray, indices: np.ndarray,
                      cap: np.ndarray) -> np.ndarray:
    """The reference's numpy allocator (`repro.sim.alloc.vector_water_fill`),
    copied: flow i holds resources ``indices[indptr[i]:indptr[i+1]]``
    (at least one), ``cap`` the rate of each resource; returns each
    flow's max-min fair rate."""
    nf = indptr.size - 1
    counts = np.diff(indptr)
    pair_flow = np.repeat(np.arange(nf), counts)
    remaining = np.array(cap, dtype=float, copy=True)
    live = np.bincount(indices, minlength=cap.size)
    rates = np.zeros(nf)
    unpinned = np.ones(nf, bool)
    n_left = nf
    # dead resources (live == 0) divide to inf or nan (0/0); fmin skips
    # nans and nothing pairs with them, so neither reaches the min
    old = np.seterr(divide="ignore", invalid="ignore")
    try:
        while n_left:
            fair = remaining / live
            m = np.fmin.reduce(fair)
            pin = np.zeros(nf, bool)
            # exact ties by design: the bitwise contract above
            hit = fair[indices] == m  # simlint: ok[FLOAT001] exact ties
            pin[pair_flow[hit]] = True
            pin &= unpinned
            rates[pin] = m
            unpinned[pin] = False
            idx = indices[pin[pair_flow]]
            np.subtract.at(remaining, idx, m)
            np.maximum(remaining, 0.0, out=remaining)
            np.subtract.at(live, idx, 1)
            n_left -= int(np.count_nonzero(pin))
    finally:
        np.seterr(**old)
    return rates


def subtract_holds_(remaining, idx, held, m):
    """`np.subtract.at(remaining, idx[held], m)` then `np.maximum(remaining,
    0.0)`, in place on `remaining` (R,) float64; `m` a 0-d float64 tensor.

    Every addend is the same -m, so `index_add_` makes, in whatever order
    it adds (atomics on the card), the same rounded `rem - m` steps per
    resource as numpy's left fold: k of them for k holds. A hold not taken
    adds -0.0, which leaves any value as it is."""
    remaining.index_add_(0, idx, torch.where(held, -m, -0.0))
    return remaining.copy_(torch.where(
        (remaining > 0) | remaining.isnan(), remaining, 0.0))


def vector_water_fill_torch(indptr: np.ndarray, indices: np.ndarray,
                            cap: np.ndarray, device=None) -> np.ndarray:
    """`vector_water_fill` as torch ops on `device` (default: the card),
    bitwise equal to it; returns the rates as a numpy float64 array. One
    host sync a round (the count of flows left)."""
    dev = resolve_device(device)
    indptr = np.asarray(indptr)
    nf = indptr.size - 1
    if nf == 0:
        return np.zeros(0)
    pair_flow = torch.from_numpy(
        np.repeat(np.arange(nf, dtype=np.int64), np.diff(indptr))).to(dev)
    idx = torch.from_numpy(np.asarray(indices, dtype=np.int64)).to(dev)
    remaining = torch.tensor(np.asarray(cap, dtype=np.float64),
                             device=dev)
    live = torch.bincount(idx, minlength=remaining.numel())
    rates = torch.zeros(nf, dtype=torch.float64, device=dev)
    unpinned = torch.ones(nf, dtype=torch.bool, device=dev)
    n_left = nf
    while n_left:
        fair = remaining / live
        m = torch.where(fair.isnan(), torch.inf, fair).min()
        hits = (fair.index_select(0, idx) == m).to(torch.int64)
        pin = (torch.zeros(nf, dtype=torch.int64, device=dev)
               .index_add_(0, pair_flow, hits) > 0) & unpinned
        rates = torch.where(pin, m, rates)
        unpinned &= ~pin
        held = pin.index_select(0, pair_flow)
        subtract_holds_(remaining, idx, held, m)
        live -= torch.zeros_like(live).index_add_(0, idx, held.to(torch.int64))
        n_left -= int(pin.sum())
    return rates.cpu().numpy()
