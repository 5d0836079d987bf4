"""Multi-pod dry-run on the GPU's terms: trace one step of every (arch x
shape x mesh) cell as one rank of the production mesh, and count what it
costs that rank (twin of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells \
        rwkv6-7b:prefill_32k:single jamba-v0.1-52b:train_4k:single \
        --cell-timeout 120

(`--cells` names arch:shape:mesh triples; `--cell-timeout` fails a cell
whose trace takes longer.)

Nothing is allocated and no card is needed. The state, caches and batch
are the abstract trees of `train/steps.py` turned into meta tensors, placed
as DTensors over a `make_fake_mesh` of 256 (16 x 16) or 512 (2 x 16 x 16,
traced as 32 x 16: see `traced_desc`) ranks of which this process is rank
0, and the port's step (`make_train_step`,
`make_prefill` or `make_serve_step`, on the plain path: a kernel needs
data) runs once on them under `StepCounter`. DTensor inserts the same
collectives it would on a real group; the fake group moves nothing. Meta
tensors, not FakeTensors, carry the trace: DTensor's sharding propagation
makes small tensors of its own and reads them back, which an active fake
tensor mode refuses, and meta tensors need no mode.

Each cell writes artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json with
the reference's keys, per device:
  - flops: by `torch.utils.flop_counter`'s formulas and rules, on each
    rank-local op (the count `FlopCounterMode` gives on one device);
  - hbm bytes: every op's tensor inputs read and outputs written, views
    excluded: an upper bound with no fusion, where the reference's is
    XLA's fused cost analysis;
  - collectives: the output bytes of each `_c10d_functional.*` / `c10d.*`
    collective by kind, on the dcn tier when its group spans pods and on
    the ici tier otherwise (the rule of `repro.launch.hlo_analysis`);
  - memory: `arg_bytes` the local shards of state (or params and caches)
    and batch; `peak_temp_bytes` the peak of the storages that are live at
    once beyond them, each rounded up to the CUDA caching allocator's
    512-byte block, tracked as `torch.distributed._tools.mem_tracker`
    tracks them;
  - the roofline on one H100 (`launch/roofline.py`) and the `sim_trace`
    block that `repro.sim.workloads.training_from_trace` replays.
`lower_s` is the trace's seconds; there is no compile (`compile_s` 0.0),
no HLO dump and no scan (`scan_trip_counts` {}).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import signal
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, supports_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import (MeshDesc, make_fake_mesh,
                                     production_mesh_desc)
from repro_torch.launch.roofline import (DEVICE, Roofline,
                                         model_flops_per_step)
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding.rules import (ShardingRules, param_specs, place,
                                        state_specs)
from repro_torch.train.steps import (abstract_caches, abstract_state,
                                     input_specs, make_prefill,
                                     make_serve_step, make_train_step)
from repro_torch.tree import tree_leaves, tree_map

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

# archs whose optimizer state must be int8 to have any chance of fitting
# a 256-chip pod (the reference's rule)
_INT8_STATE = {"kimi-k2-1t-a32b", "llama3-405b", "llama-3.2-vision-90b"}

# the CUDA caching allocator's smallest block
_BLOCK = 512

# ops that read tensor metadata only (FlopCounterMode skips the same)
_aten = torch.ops.aten
_METADATA = {_aten.is_contiguous.default, _aten.is_contiguous.memory_format,
             _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default, _aten.size.default,
             _aten.sym_size.default, _aten.stride.default,
             _aten.sym_stride.default, _aten.storage_offset.default,
             _aten.sym_storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default,
             torch.ops.prim.layout.default}

# collective op name -> the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLL_NAMESPACES = {"_c10d_functional", "c10d_functional", "c10d"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _storages(tree) -> list:
    """The distinct storages of `tree`'s tensors (a DTensor's: its local
    shard's)."""
    if type(tree) is torch.Tensor:              # an op's usual output
        return [tree.untyped_storage()]
    out = WeakIdKeyDictionary()
    for t in _tensors(tree_leaves(tree)):
        if isinstance(t, DTensor):
            t = t.to_local()
        out[t.untyped_storage()] = None
    return list(out.keys())


@functools.cache
def _decomposes(func) -> bool:
    """Whether `func.decompose` has a decomposition to run (else it returns
    NotImplemented)."""
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    return dk in func.py_kernels or \
        torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk)


@functools.cache
def _fresh_outputs(func) -> bool:
    """Whether `func` returns only new tensors whose shapes, strides and
    dtypes follow from its arguments' (an out-of-place op whose output
    shape does not depend on the data)."""
    schema = func._schema
    return bool(schema.returns) and not schema.is_mutable and \
        func.namespace not in _COLL_NAMESPACES and \
        all(r.alias_info is None and str(r.type) == "Tensor"
            for r in schema.returns) and \
        not {torch.Tag.dynamic_output_shape,
             torch.Tag.data_dependent_output} & set(func.tags)


def _meta_key(x):
    """A hashable stand-in for an op's argument that determines its
    outputs' metadata (a meta tensor by its shape, strides and dtype);
    None where there is none (a tensor not on meta, or an unhashable
    argument)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            return None
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        keys = tuple(_meta_key(y) for y in x)
        return None if any(k is None for k in keys) else keys
    if isinstance(x, dict):
        return _meta_key(tuple(x.items()))
    try:
        hash(x)
    except TypeError:
        return None
    return ("value", x)


def _in_fake_mode() -> bool:
    """True inside DTensor's sharding propagation, which runs ops on fake
    tensors under a FakeTensorMode of its own: those ops are not the
    step's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


class StepCounter(TorchDispatchMode):
    """Per-device costs of the ops run under it.

    Ops on DTensors are handed back to DTensor, so the counter sees each
    rank-local op, and the collectives DTensor issues. `pod_size` ranks
    make a pod: a collective whose group holds ranks of two pods is on
    the dcn tier (None: no pods, all ici)."""

    def __init__(self, pod_size=None, block=_BLOCK):
        super().__init__()
        self.pod_size = pod_size
        self.block = block
        # set by `trace_cell`
        self.arg_bytes = self.output_bytes = self.peak_temp_bytes = 0
        self.flops = 0
        self.hbm_bytes = 0
        self.coll_by_kind: dict = {}
        self.ici_bytes = 0
        self.dcn_bytes = 0
        self.n_coll_ops = 0
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self._depth = 0           # inside a decomposition
        # (op, arguments' metadata) -> its outputs' (shape, stride, dtype):
        # a step repeats its ops on the same shapes (layer after layer,
        # chunk after chunk), and a meta kernel costs more than a lookup
        self._out_meta: dict = {}

    # ---- memory ----

    def track(self, tree) -> int:
        """Count the storages of `tree` not seen before as live until they
        are freed; returns their bytes (unrounded)."""
        added = 0
        for st in _storages(tree):
            if st in self._storages:
                continue
            added += st.nbytes()
            n = -(-st.nbytes() // self.block) * self.block
            self._storages[st] = weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, n: int) -> None:
        self.live -= n

    # ---- collectives ----

    def _crosses_pods(self, func, args, kwargs) -> bool:
        if not self.pod_size:
            return False
        ranks = None
        schema = func._schema
        for i, a in enumerate(schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            if a.name == "group_name":
                from torch.distributed.distributed_c10d import (
                    _resolve_process_group)
                ranks = dist.get_process_group_ranks(
                    _resolve_process_group(v))
            elif a.name == "process_group":
                # the c10d ops take the group boxed as a ScriptObject
                if isinstance(v, torch.ScriptObject):
                    v = dist.ProcessGroup.unbox(v)
                ranks = dist.get_process_group_ranks(v)
        if ranks is None:
            return True          # unknown group: assume global
        return len({r // self.pod_size for r in ranks}) > 1

    def _collective(self, func, args, kwargs, out) -> None:
        kind = _COLLECTIVES[func._overloadpacket.__name__]
        # functional collectives return their output; the in-place c10d
        # ops write their first argument
        written = out if func.namespace != "c10d" else args[0]
        b = sum(t.nbytes for t in _tensors(written))
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0) + b
        self.n_coll_ops += 1
        if self._crosses_pods(func, args, kwargs):
            self.dcn_bytes += b
        else:
            self.ici_bytes += b

    # ---- dispatch ----

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func in _METADATA:
            return NotImplemented
        if _in_fake_mode():
            return func(*args, **kwargs)
        if func is torch.ops._c10d_functional.wait_tensor.default:
            # eager waits in place; the meta kernel would make a new tensor
            return args[0]
        # FlopCounterMode's rule: an op without a formula is decomposed,
        # where it can be, and its parts' FLOPs counted; its bytes and
        # memory are the whole op's, as it runs eagerly
        if func not in flop_registry and \
                func is not torch.ops.prim.device.default and \
                _decomposes(func):
            self._depth += 1
            try:
                with self:
                    out = func.decompose(*args, **kwargs)
            finally:
                self._depth -= 1
            if out is not NotImplemented:
                self._account(func, args, kwargs, out)
                return out
        out = self._run(func, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        self._account(func, args, kwargs, out)
        return out

    def _run(self, func, args, kwargs):
        """func(*args, **kwargs) on meta tensors, its outputs made from
        their metadata where `func` ran on the same before."""
        key = _meta_key((args, kwargs)) if _fresh_outputs(func) else None
        if key is None:
            return func(*args, **kwargs)
        metas = self._out_meta.get((func, key))
        if metas is None:
            out = func(*args, **kwargs)
            self._out_meta[func, key] = [
                (t.shape, t.stride(), t.dtype)
                for t in (out if isinstance(out, tuple) else (out,))]
            return out
        outs = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device="meta")
                     for shape, stride, dtype in metas)
        return outs if len(func._schema.returns) > 1 else outs[0]

    def _account(self, func, args, kwargs, out) -> None:
        """Bytes, collectives and memory of one op run eagerly (not of the
        parts of a decomposition)."""
        if self._depth:
            return
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if func.namespace in _COLL_NAMESPACES:
            if func._overloadpacket.__name__ in _COLLECTIVES:
                self._collective(func, args, kwargs, out)
        elif not view:
            # a view moves nothing; everything else reads its inputs and
            # writes its outputs once (no fusion)
            self.hbm_bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
            self.hbm_bytes += sum(t.nbytes for t in _tensors(out))
        if not view:
            # nor does it allocate: a view of a storage made outside the
            # step (a tensor a process-wide cache holds) is not the step's
            self.track(out)


def _meta(tree):
    """Each tensor leaf of an abstract tree as a meta tensor (ints
    stay)."""
    return tree_map(lambda t: t if isinstance(t, int) else
                    torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def _opt_cfg(arch: str) -> OptimizerConfig:
    int8 = arch in _INT8_STATE
    return OptimizerConfig(state_dtype="int8" if int8 else "float32",
                           master=not int8)


def _config(arch, *, compute_dtype=None, attn_block=None, cfg_overrides=None):
    cfg = get_config(arch)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if attn_block:
        cfg = dataclasses.replace(cfg, attn_block=attn_block)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    return cfg


def traced_desc(desc: MeshDesc, grad_sync="gspmd") -> MeshDesc:
    """The mesh a cell of `desc` is traced on. A ("pod", "data", "model")
    mesh is traced as ("data", "model") with pod x data ranks on "data",
    in the same rank order, except for the compressed pod sync, which
    needs the pod axis (and runs its step on the 2-d ("data", "model")
    sub-mesh). The state and batch are sharded over ("pod", "data")
    jointly either way, so the flat axis holds the same shards and its
    groups span both pods, as the reference's XLA groups over
    ("pod", "data") do; DTensor on the 3-d mesh would issue one collective
    per axis instead, and its sharding propagation takes 0.1-0.6 s an op
    there (over 10 minutes for one h2o-danube-1.8b train step, against
    25 s flat, on the CPU)."""
    if "pod" not in desc.axis_names or grad_sync == "compressed_pod":
        return desc
    return MeshDesc(("data", "model"),
                    (desc.shape["pod"] * desc.shape["data"],
                     desc.shape["model"]))


def cell_inputs(cfg, shape: ShapeConfig, desc: MeshDesc | None, *,
                opt_cfg: OptimizerConfig, grad_sync="gspmd", remat=True,
                fsdp=True, tp=None) -> tuple:
    """(step, args) of one cell, on meta tensors: the step of `shape`'s
    kind on the plain path, its arguments placed as DTensors over a
    `make_fake_mesh` of `traced_desc(desc)` (None: one device, no mesh;
    pods keep their tier, see `trace_cell`) as the reference's
    dry-run places them: the train state by `state_specs`, params by
    `param_specs` (FSDP off for decode with `fsdp=False`), caches by
    `cache_specs`, the batch over ("pod", "data") (whole for the compressed
    pod sync, which splits it itself). Heads are padded for `tp` ranks
    (default: the mesh's "model" axis, 1 without a mesh)."""
    live = desc is not None
    if live:
        desc = traced_desc(desc, grad_sync)
    mesh = make_fake_mesh(desc) if live else None
    if tp is None:
        tp = desc.shape["model"] if live else 1
    rules = None
    if live:
        dp = math.prod(desc.shape[n] for n in ("pod", "data")
                       if n in desc.axis_names)
        rules = ShardingRules(mesh, seq_sharded=(
            shape.kind == "decode" and shape.global_batch < dp))
    batch = _meta(input_specs(cfg, shape))
    compressed = grad_sync == "compressed_pod"
    if live and not (shape.kind == "train" and compressed):
        # the compressed step takes the batch whole and splits it over
        # pods itself
        batch = rules.shard_batch(batch)
    if shape.kind == "train":
        state = _meta(abstract_state(cfg, opt_cfg, tp, with_ef=compressed))
        if live:
            state = place(state, state_specs(state, mesh,
                                             fsdp_pod=not compressed), mesh)
        return (make_train_step(cfg, opt_cfg, rules, use_kernels=False,
                                remat=remat, grad_sync=grad_sync),
                (state, batch))
    params = _meta(abstract_state(cfg, opt_cfg, tp).params)
    caches = _meta(abstract_caches(cfg, shape, tp))
    if live:
        params = place(params, param_specs(
            params, mesh, fsdp=fsdp or shape.kind != "decode"), mesh)
        caches = place(caches, rules.cache_specs(caches), mesh)
    if shape.kind == "prefill":
        return (make_prefill(cfg, rules, use_kernels=False),
                (params, caches, batch))
    return (make_serve_step(cfg, rules, use_kernels=False),
            (params, caches, batch["token"]))


def trace_cell(cfg, shape: ShapeConfig, desc: MeshDesc | None, *,
               block=_BLOCK, **kw) -> StepCounter:
    """Run one step of `cell_inputs(cfg, shape, desc, **kw)` under a
    `StepCounter` (storages rounded up to `block` bytes) and return it,
    with `arg_bytes` and `output_bytes` set."""
    step, args = cell_inputs(cfg, shape, desc, **kw)
    pod_size = None
    if desc is not None and "pod" in desc.axis_names:
        pod_size = math.prod(desc.axis_sizes) // desc.shape["pod"]
    counter = StepCounter(pod_size, block=block)
    counter.arg_bytes = counter.track(args)
    held = counter.live
    with counter:
        out = step(*args)
    counter.peak_temp_bytes = counter.peak - held
    inputs = WeakIdKeyDictionary({st: None for st in _storages(args)})
    counter.output_bytes = sum(st.nbytes() for st in _storages(out)
                               if st not in inputs)
    return counter


def cell_record(cfg, shape: ShapeConfig, desc: MeshDesc | None,
                mesh_name: str, *, opt_cfg: OptimizerConfig,
                grad_sync="gspmd", remat=True, fsdp=True, tag="") -> dict:
    """The record of one cell, with the reference's keys; `desc` as in
    `cell_inputs`, named `mesh_name`."""
    n_dev = 1 if desc is None else math.prod(desc.axis_sizes)
    t0 = time.perf_counter()  # simlint: ok[DET002]
    c = trace_cell(cfg, shape, desc, opt_cfg=opt_cfg, grad_sync=grad_sync,
                   remat=remat, fsdp=fsdp)
    t1 = time.perf_counter()  # simlint: ok[DET002]
    mf = model_flops_per_step(cfg, shape) / n_dev
    roof = Roofline(flops=c.flops, hbm_bytes=c.hbm_bytes,
                    ici_bytes=c.ici_bytes, dcn_bytes=c.dcn_bytes,
                    model_flops=mf)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "grad_sync": grad_sync, "tag": tag,
        "n_devices": n_dev, "path": "plain", "device": DEVICE,
        # DTensor's sharding propagation differs between torch releases,
        # and with it the counts
        "torch": torch.__version__,
        "traced_mesh": None if desc is None else dict(zip(
            *dataclasses.astuple(traced_desc(desc, grad_sync)))),
        "lower_s": round(t1 - t0, 1), "compile_s": 0.0,
        "bytes_per_device": c.peak_temp_bytes + c.arg_bytes,
        "peak_temp_bytes": c.peak_temp_bytes,
        "arg_bytes": c.arg_bytes,
        "output_bytes": c.output_bytes,
        "collectives": {"by_kind": c.coll_by_kind,
                        "ici_bytes": c.ici_bytes,
                        "dcn_bytes": c.dcn_bytes,
                        "n_ops": c.n_coll_ops},
        "scan_trip_counts": {},
        "roofline": roof.to_dict(),
        # consumed by repro.sim.workloads.training_from_trace
        "sim_trace": {
            "n_devices": n_dev,
            "phases": [
                {"kind": "compute", "flops": c.flops,
                 "hbm_bytes": c.hbm_bytes},
                {"kind": "collective_phase", "tier": "ici",
                 "bytes": c.ici_bytes},
                {"kind": "collective_phase", "tier": "dcn",
                 "bytes": c.dcn_bytes},
            ],
        },
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             grad_sync="gspmd", remat=True, save=True, tag="",
             compute_dtype=None, attn_block=None, cfg_overrides=None,
             fsdp=True) -> dict:
    """The record of `arch` at the SHAPES entry `shape_name` on the
    production mesh `mesh_kind` ("single": 16 x 16, "multi": 2 x 16 x 16),
    skipped where the arch does not support the shape; saved under `ART`
    with `save`."""
    shape = SHAPES[shape_name]
    ok, why = supports_shape(get_config(arch), shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    cfg = _config(arch, compute_dtype=compute_dtype, attn_block=attn_block,
                  cfg_overrides=cfg_overrides)
    rec = cell_record(cfg, shape,
                      production_mesh_desc(multi_pod=mesh_kind == "multi"),
                      mesh_kind, opt_cfg=_opt_cfg(arch), grad_sync=grad_sync,
                      remat=remat, fsdp=fsdp, tag=tag)
    if save:
        ART.mkdir(parents=True, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_kind}"
        if tag:
            name += f"__{tag}"
        (ART / f"{name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--grad-sync", default="gspmd")
    ap.add_argument("--tag", default="")
    ap.add_argument("--compute-dtype", default=None)
    ap.add_argument("--attn-block", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--cells", nargs="+", default=None,
                    help="arch:shape:mesh triples, in place of the "
                    "--arch / --shape / --mesh grid")
    ap.add_argument("--cell-timeout", type=int, default=0,
                    help="fail a cell whose trace takes longer (seconds)")
    args = ap.parse_args()

    cells = []
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = ([tuple(c.split(":")) for c in args.cells] if args.cells else
            [(a, s, m) for a in archs for s in shapes for m in meshes])

    def expired(*_):
        raise TimeoutError(f"trace over {args.cell_timeout} s")
    signal.signal(signal.SIGALRM, expired)
    fails = 0
    try:
        for arch, shape, mk in todo:
            signal.alarm(args.cell_timeout)
            try:
                rec = run_cell(arch, shape, mk, grad_sync=args.grad_sync,
                               tag=args.tag, remat=not args.no_remat,
                               attn_block=args.attn_block,
                               compute_dtype=args.compute_dtype)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "status": "fail", "error": f"{type(e).__name__}: {e}"}
                fails += 1
            finally:
                signal.alarm(0)
            cells.append(rec)
            r = rec.get("roofline", {})
            print(f"[{rec['status']:7s}] {arch:24s} {shape:12s} "
                  f"{mk:6s} trace={rec.get('lower_s', '-')}s "
                  f"bottleneck={r.get('bottleneck', '-')} "
                  f"step={1e3 * max(r.get('t_compute', 0), r.get('t_memory', 0), r.get('t_collective', 0)):.1f}ms "
                  f"roof={r.get('roofline_fraction', 0):.3f} "
                  f"useful={r.get('useful_ratio', 0):.4f} "
                  f"torch={rec.get('torch', torch.__version__)} "
                  f"{rec.get('reason', rec.get('error', ''))}"[:240],
                  flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\n{sum(1 for c in cells if c['status'] == 'ok')} ok, "
          f"{sum(1 for c in cells if c['status'] == 'skipped')} skipped, "
          f"{fails} failed")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
