"""Meshes over the ranks of the current process group (port of
`repro.launch.mesh`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the dim names
("pod",) "data", "model": batch and FSDP ride ("pod", "data"), tensor and
expert parallelism ride "model". `MeshDesc` stands in for the reference's
`AbstractMesh`: axis names and sizes with no process group, enough to
compute sharding specs for the production meshes (16 x 16 = 256 ranks, and
2 x 16 x 16 across two pods) without 256 ranks.

The reference's `compat.shard_map` has no twin here. Code under a process
group already runs once per rank on that rank's shards, so a per-shard
body is just code; and a body that is manual over "pod" alone runs on the
pod's ("data", "model") sub-mesh, `mesh["data", "model"]`, with the pod
group `mesh.get_group("pod")` for its collectives (see
`core/collectives.py` and `train/steps.py`).

`make_fake_mesh` stands in for the reference's 512 host devices of its
dry-run: an in-process group of that many ranks on the `fake` backend, of
which this process is rank 0. Its collectives move nothing, so rank 0 can
trace its own shard of a step over the production mesh
(`launch/dryrun.py`).
"""
from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh's axis names and sizes, without devices or process group."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def describe(mesh) -> MeshDesc:
    """The `MeshDesc` of a `DeviceMesh` (a `MeshDesc` passes through)."""
    if isinstance(mesh, MeshDesc):
        return mesh
    # sizes from `size(i)`: `mesh.mesh` builds a tensor, which a fake
    # tensor mode would refuse
    return MeshDesc(tuple(mesh.mesh_dim_names),
                    tuple(mesh.size(i) for i in range(mesh.ndim)))


def production_mesh_desc(*, multi_pod: bool = False) -> MeshDesc:
    """The production mesh's description: (16, 16) ("data", "model") on one
    pod, (2, 16, 16) ("pod", "data", "model") across two."""
    if multi_pod:
        return MeshDesc(("pod", "data", "model"), (2, 16, 16))
    return MeshDesc(("data", "model"), (16, 16))


def device_type() -> str:
    """"cuda" under an NCCL process group, else "cpu" (gloo, fake)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


# One DeviceMesh per (process group, shape, names) in a process. DTensor
# caches sharding decisions by mesh *value*, and a cached decision carries
# the mesh it was first made on: a second, equal mesh with groups of its
# own would then mix the two meshes' groups, in another order on each rank,
# and the collectives hang. Reusing the mesh keeps one set of groups.
_MESHES: dict = {}


def make_mesh(shape, axis_names) -> DeviceMesh:
    """The mesh of `shape` over all ranks of the current process group,
    whose world size must be the product of `shape` (the same object for
    the same arguments and process group)."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world != n:
        raise RuntimeError(
            f"a {' x '.join(map(str, shape))} {tuple(axis_names)} mesh needs "
            f"a process group of {n} ranks; found world size {world}"
            + ("" if dist.is_initialized() else " (no process group: start "
               "one, e.g. with torchrun)"))
    # the backend in the key too: a fake group's mesh is never handed to a
    # real group
    key = (dist.group.WORLD, dist.get_backend(), tuple(shape),
           tuple(axis_names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type(), tuple(shape),
                                        mesh_dim_names=tuple(axis_names))
    return _MESHES[key]


def make_fake_mesh(desc: MeshDesc) -> DeviceMesh:
    """The mesh of `desc` on an in-process `fake` process group of
    prod(desc.axis_sizes) ranks, this process rank 0. A fake group this
    process opened before, of another size, is closed first; any other
    open process group is an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(desc.axis_sizes)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a fake mesh needs its own process group; this process "
                f"already has a {dist.get_backend()!r} group open")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_mesh(desc.axis_sizes, desc.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    d = production_mesh_desc(multi_pod=multi_pod)
    return make_mesh(d.axis_sizes, d.axis_names)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the process group's data x model ranks."""
    return make_mesh((data, model), ("data", "model"))


def mesh_axes(mesh) -> dict:
    names = describe(mesh).axis_names
    return {
        "batch": tuple(n for n in ("pod", "data") if n in names),
        "model": ("model",) if "model" in names else (),
        "fsdp": tuple(n for n in ("pod", "data") if n in names),
    }
