"""Lovelock §6 collective schedules: phi-aware gradient sync (port of
`repro.core.collectives`, over `torch.distributed` groups of a mesh).

The paper's concern: splitting accelerators across more NICs (phi > 1)
multiplies *cross-host* all-reduce traffic by phi. The expensive hop is
the cross-pod edge of the mesh. Three schedules:

  * gspmd        — the collectives DTensor inserts (baseline).
  * hierarchical — explicit reduce-scatter(data) -> all-reduce(pod) ->
                   all-gather(data): the cross-pod hop moves 1/|data| of
                   the bytes.
  * compressed   — int8 quantization with error feedback on exactly the
                   pod hop (a scale shared across pods, so the sum is
                   well-defined). The reference's wire format is int16;
                   here it is int32, since neither gloo nor NCCL sums int16
                   (the sum is exact either way). The information content is
                   8 bits an element and the achievable wire traffic 1 B an
                   element: the traffic model reports the reference's
                   numbers.

`mesh` is a `DeviceMesh` with dim names among ("pod", "data", "model").
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.tree import tree_leaves, tree_unflatten

Pytree = Any


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _like(x, local):
    """`local` as a DTensor placed as `x` (or itself for a plain x)."""
    if not isinstance(x, DTensor):
        return local
    return DTensor.from_local(local, x.device_mesh, x.placements)


# ---------------------------------------------------------------------------
# The sync of one train step (the reference calls these inside a shard_map
# manual over 'pod'; here each rank runs them on its own shards)
# ---------------------------------------------------------------------------


def quantized_psum_pod(x, ef, mesh, *, axis: str = "pod"):
    """int8 error-feedback mean over the `axis` ranks of `mesh`.

    x: a float32 / bf16 gradient leaf; ef: its running error (bf16); both
    plain tensors (the whole leaf on this rank) or DTensors on the pod's
    sub-mesh, placed alike. Every pod holds the same shards of the leaf.
    Returns (mean over pods, new_ef), placed as x and ef.
    """
    group = mesh.get_group(axis)
    npods = dist.get_world_size(group)
    val = x.float() + ef.float()
    # the scale is shared by the whole leaf on every pod: the max over this
    # pod's shards of the leaf (DTensor reduces across them), then over pods
    local_max = val.abs().max()
    if isinstance(local_max, DTensor):
        local_max = local_max.full_tensor()
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    v = _local(val).contiguous()      # NCCL sends contiguous buffers

    def const(c):
        # a divisor on the device: CUDA divides by a host scalar through
        # its reciprocal, which is not the reference's rounding
        return torch.full((), c, dtype=torch.float32, device=v.device)
    scale = torch.clamp(local_max / const(127.0), min=1e-12)
    q = torch.clamp(torch.round(v / scale), -127, 127)
    new_ef = (v - q * scale).to(ef.dtype)
    # the wire sum in int32: neither gloo nor NCCL sums int16. At most 256
    # pods of values in [-127, 127] sum exactly in int16 (the reference's
    # wire type) and in int32 alike, so the result is the same bit for bit
    wire = q.to(torch.int32)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    out = (wire.float() * scale / const(npods)).to(x.dtype)
    return _like(x, out), _like(ef, new_ef)


def compressed_pod_sync(grads: Pytree, ef: Pytree, mesh) -> tuple[Pytree,
                                                                  Pytree]:
    """`quantized_psum_pod` over 'pod' on every gradient leaf. The
    identity when the mesh has no pod axis (single-pod training)."""
    if "pod" not in mesh.mesh_dim_names:
        return grads, ef
    out = [quantized_psum_pod(g, e, mesh) for g, e in
           zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(ef, [o[1] for o in out]))


# ---------------------------------------------------------------------------
# Standalone schedules (used by tests / the traffic benchmark)
# ---------------------------------------------------------------------------


def _replica_row(mesh, axes) -> int:
    """This rank's row of an (R, N) replica array: its position in the
    `axes` grid, the first axis major."""
    row = 0
    for a in axes:
        row = row * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return row


def _group_over(mesh, axes):
    """The process group of this rank's ranks along `axes` (the other mesh
    dims fixed). Every rank must call it, in the same order."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    names = mesh.mesh_dim_names
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    n = math.prod(mesh.mesh.shape[i] for i in keep)
    grid = mesh.mesh.permute(*rest, *keep).reshape(-1, n)
    mine = None
    for ranks in grid.tolist():
        g = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = g
    return mine


def flat_all_reduce(x, mesh, axes=("pod", "data")):
    """x: (R, N), one gradient replica per (pod, data) position. Returns
    the sum as (1, N) on every rank: one flat all-reduce over those
    ranks."""
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    v = x[_replica_row(mesh, axes)].clone()
    dist.all_reduce(v, group=_group_over(mesh, axes))
    return v[None]


def hierarchical_all_reduce(x, mesh):
    """x: (R, N) replicas -> (1, N) sum via
    reduce-scatter(data) -> all-reduce(pod) -> all-gather(data).

    Cross-pod bytes shrink by |data| relative to a flat global all-reduce.
    N must be divisible by |data|.
    """
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    v = x[_replica_row(mesh, axes)].contiguous()
    data = mesh.get_group("data")
    n = dist.get_world_size(data)
    shard = torch.empty(v.shape[0] // n, dtype=v.dtype, device=v.device)
    dist.reduce_scatter_tensor(shard, v, group=data)
    if "pod" in axes:
        dist.all_reduce(shard, group=mesh.get_group("pod"))
    out = torch.empty_like(v)
    dist.all_gather_into_tensor(out, shard, group=data)
    return out[None]


# ---------------------------------------------------------------------------
# Traffic model (a copy of the reference's; no jax in it)
# ---------------------------------------------------------------------------


def allreduce_traffic_model(n_bytes: int, *, n_pods: int, data: int,
                            schedule: str) -> dict:
    """Per-device DCN / ICI bytes for one gradient all-reduce.

    Ring algorithms: all-reduce moves 2*(k-1)/k * N per device; reduce-
    scatter and all-gather each (k-1)/k * N.
    """
    def ring(k, n):
        return 2 * (k - 1) / k * n

    if schedule == "flat":
        # one global ring across pods: every byte crosses DCN in the worst
        # case; model the DCN share as the pod-crossing fraction
        total = ring(n_pods * data, n_bytes)
        dcn = total * (n_pods - 1) / n_pods if n_pods > 1 else 0.0
        return {"ici_bytes": total - dcn, "dcn_bytes": dcn}
    if schedule in ("hierarchical", "compressed"):
        rs = (data - 1) / data * n_bytes
        ag = (data - 1) / data * n_bytes
        cross = ring(n_pods, n_bytes / data) if n_pods > 1 else 0.0
        if schedule == "compressed":
            cross /= 4.0          # fp32 -> int8 information content
        return {"ici_bytes": rs + ag, "dcn_bytes": cross}
    raise ValueError(schedule)


class CollectiveTrafficComponent:
    """Expands one gradient all-reduce into per-device (tier, bytes) phases,
    as the simulator's `training_from_trace` replays them."""

    def __init__(self, schedule: str = "hierarchical"):
        self.schedule = schedule

    def phases(self, n_bytes: float, *, n_pods: int = 1,
               data: int = 1) -> list[dict]:
        t = allreduce_traffic_model(int(n_bytes), n_pods=n_pods, data=data,
                                    schedule=self.schedule)
        out = []
        if t["ici_bytes"] > 0:
            out.append({"kind": "collective_phase", "tier": "ici",
                        "bytes": t["ici_bytes"]})
        if t["dcn_bytes"] > 0:
            out.append({"kind": "collective_phase", "tier": "dcn",
                        "bytes": t["dcn_bytes"]})
        return out


def phi_traffic_scaling(n_bytes: int, phi: int, accel_per_host: int = 4)\
        -> dict:
    """The paper's §6 claim: hosting fewer accelerators per NIC multiplies
    cross-host all-reduce traffic by phi.

    Traditional: a accelerators reduce over NVLink/ICI first, then one
    cross-host ring over n hosts: cross bytes/host ~ 2*N.
    Lovelock phi>1: a/phi accelerators per NIC => phi x more nodes in the
    cross-host ring carrying the same N bytes each.
    """
    base = 2.0 * n_bytes
    return {"traditional_cross_bytes": base,
            "lovelock_cross_bytes": base * phi,
            "ratio": float(phi)}
