"""The port's dry-run (`repro_torch.launch.dryrun`) against the reference's
`repro.launch.dryrun` and `repro.launch.hlo_analysis`:

- `input_specs`, `abstract_caches` and `abstract_state` leaf for leaf
  (path, shape, dtype) against the reference's `jax.eval_shape` trees for
  every `ALL_ARCHS` x `SHAPES` cell the arch supports;
- `model_flops_per_step` against the reference's formula (1e-12 relative);
- the per-device `arg_bytes` of every train cell on the production meshes
  against the bytes reckoned in numpy from the reference's `state_specs`
  on `make_abstract_mesh` (exact);
- at smoke size: the trace's FLOPs and memory at world 1 against
  `FlopCounterMode` and `MemTracker` around the real CPU step (exact), the
  collective tiers on fake (2, 4) and (2, 2, 2) meshes, and the record's
  `sim_trace` replayed by `repro.sim.workloads.training_from_trace`;
- `make_fake_mesh` and the mesh cache beside a real (gloo) group.
"""
import dataclasses
import functools
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor  # noqa: E402
from torch.distributed._tools.mem_tracker import MemTracker  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro.configs import supports_shape  # noqa: E402
from repro.launch.hlo_analysis import model_flops_per_step as jflops  # noqa: E402,E501
from repro.launch.mesh import make_abstract_mesh  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.sharding.rules import ShardingRules as JRules  # noqa: E402
from repro.sharding.rules import state_specs as jstate_specs  # noqa: E402
from repro.sim import lovelock_cluster, training_from_trace  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import smoke_variant  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.streaming_checkpoint import _leaf_paths  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.launch.mesh import MeshDesc  # noqa: E402
from repro_torch.launch.roofline import model_flops_per_step  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

PROD = {"single": (make_abstract_mesh((16, 16), ("data", "model")),
                   TMesh.production_mesh_desc()),
        "multi": (make_abstract_mesh((2, 16, 16), ("pod", "data", "model")),
                  TMesh.production_mesh_desc(multi_pod=True))}
SMOKE = smoke_variant(tget_config("h2o-danube-1.8b"))
SMOKE_SHAPE = ShapeConfig("smoke", 16, 8, "train")


@pytest.fixture(autouse=True)
def _no_group_left_open():
    """A test that opens a (fake or gloo) process group closes it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _jopt(arch):
    if arch in D._INT8_STATE:
        return JOptimizerConfig(state_dtype="int8", master=False)
    return JOptimizerConfig()


def _jax_leaves(tree) -> list:
    """[(path, shape, dtype name)] of a reference abstract tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx",
                                                    getattr(k, "name", k))))
                      for k in path), tuple(x.shape), str(x.dtype))
            for path, x in leaves]


def _torch_leaves(tree) -> list:
    """[(path, shape, dtype name)] of a port abstract tree; an int leaf
    (the state's step, the caches' index) stands for the reference's
    0-d int32."""
    out = []
    for path, t in _leaf_paths(tree):
        if isinstance(t, int):
            out.append((path, (), "int32"))
        else:
            assert isinstance(t, FakeTensor), path
            out.append((path, tuple(t.shape),
                        str(t.dtype).removeprefix("torch.")))
    return out


def _cells(arch):
    cfg = get_config(arch)
    return [name for name, sh in SHAPES.items() if supports_shape(cfg, sh)[0]]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_trees_match_reference(arch):
    """input_specs for every supported shape, abstract_caches for the
    prefill and decode shapes (tp 16) and abstract_state (tp 16, the
    dry-run's optimizer state) equal the reference's leaf for leaf."""
    jcfg, tcfg = get_config(arch), tget_config(arch)
    for name in _cells(arch):
        jsh, tsh = SHAPES[name], TSHAPES[name]
        assert _torch_leaves(TS.input_specs(tcfg, tsh)) == \
            _jax_leaves(JS.input_specs(jcfg, jsh))
        if jsh.kind != "train":
            assert _torch_leaves(TS.abstract_caches(tcfg, tsh, 16)) == \
                _jax_leaves(JS.abstract_caches(jcfg, jsh, 16))
    topt = D._opt_cfg(arch)
    assert dataclasses.asdict(topt) == dataclasses.asdict(_jopt(arch))
    assert _torch_leaves(TS.abstract_state(tcfg, topt, 16)) == \
        _jax_leaves(JS.abstract_state(jcfg, _jopt(arch), 16))


def test_abstract_state_with_ef_matches_reference():
    arch = "h2o-danube-1.8b"
    got = TS.abstract_state(tget_config(arch), OptimizerConfig(), 16,
                            with_ef=True)
    want = JS.abstract_state(get_config(arch), JOptimizerConfig(), 16,
                             with_ef=True)
    assert _torch_leaves(got) == _jax_leaves(want)
    assert any(p.startswith("ef/") for p, _, _ in _torch_leaves(got))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_flops_match_reference(arch):
    for name in _cells(arch):
        want = jflops(get_config(arch), SHAPES[name])
        got = model_flops_per_step(tget_config(arch), TSHAPES[name])
        assert got == pytest.approx(want, rel=1e-12)


@functools.cache
def _jstate(arch):
    return JS.abstract_state(get_config(arch), _jopt(arch), 16)


def _spec_size(spec, sizes) -> int:
    """How many ways a spec splits its dims over `sizes`."""
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else ((ax,) if ax else ())):
            n *= sizes[a]
    return n


def _reference_arg_bytes(arch, mesh) -> int:
    """Per-device bytes of the reference's train state and batch, from its
    state_specs and batch spec on `mesh` (an AbstractMesh). The state's
    `step` is left out: a 0-d int32 there, a host int in the port."""
    jmesh = PROD[mesh][0]
    sizes = dict(zip(jmesh.axis_names, jmesh.axis_sizes))
    state = _jstate(arch)
    specs = jstate_specs(state, jmesh)
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    sleaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    total = 0
    for (path, leaf), spec in zip(leaves, sleaves):
        if getattr(path[0], "name", None) == "step":
            continue
        n = int(np.prod(leaf.shape, dtype=np.int64))
        total += n // _spec_size(spec, sizes) * leaf.dtype.itemsize
    tok = tuple(JRules(jmesh).table["tokens"])
    for leaf in jax.tree.leaves(JS.input_specs(get_config(arch),
                                               SHAPES["train_4k"])):
        # the reference's _batch_shardings: the batch dim over the batch
        # axes where they divide it
        ways = _spec_size(tok[:1], sizes)
        ways = ways if leaf.shape[0] % ways == 0 else 1
        total += int(np.prod(leaf.shape)) // ways * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_arg_bytes_match_reference_specs(arch, mesh):
    """arg_bytes of the dry-run's train cell: the local shards of the
    placed meta state and batch on rank 0 of the fake production mesh."""
    tcfg = tget_config(arch)
    _, args = D.cell_inputs(tcfg, TSHAPES["train_4k"], PROD[mesh][1],
                            opt_cfg=D._opt_cfg(arch))
    assert D.StepCounter().track(args) == _reference_arg_bytes(arch, mesh)


def _real_step_counts():
    """FlopCounterMode's FLOPs and MemTracker's peak around one real CPU
    plain-path train step of the smoke model (state and batch tracked)."""
    oc = OptimizerConfig()
    state = adamw_init(TM.init_params(torch.Generator().manual_seed(0),
                                      SMOKE), oc)
    rng = np.random.default_rng(0)
    B, S = SMOKE_SHAPE.global_batch, SMOKE_SHAPE.seq_len
    batch = {k: torch.from_numpy(rng.integers(0, SMOKE.vocab_size, (B, S),
                                              dtype=np.int32))
             for k in ("tokens", "labels")}
    step = TS.make_train_step(SMOKE, oc, use_kernels=False)
    mt = MemTracker()
    mt.track_external(*[t for t in tree_leaves(state)
                        if isinstance(t, torch.Tensor)], *batch.values())
    with FlopCounterMode(display=False) as fc, mt:
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    return fc.get_total_flops(), mt.get_tracker_snapshot("peak")[
        torch.device("cpu")]["Total"]


def test_world1_trace_equals_the_real_step():
    """Meshless, the trace on meta tensors counts exactly the FLOPs that
    FlopCounterMode counts around the real step, and (storages unrounded)
    exactly MemTracker's peak."""
    flops, peak = _real_step_counts()
    c = D.trace_cell(SMOKE, SMOKE_SHAPE, None, opt_cfg=OptimizerConfig(),
                     block=1)
    assert c.flops == flops > 0
    assert c.peak_temp_bytes + c.arg_bytes == peak
    assert c.hbm_bytes > 0 and c.n_coll_ops == 0


def test_fake_mesh_collective_tiers():
    """On a fake (2, 4) mesh (no pod axis) every collective is on the ici
    tier; on a fake (2, 2, 2) mesh the compressed pod sync puts bytes on
    the dcn tier. Each rank holds a shard of the state, and the record's
    sim_trace replays in the reference's simulator."""
    oc = OptimizerConfig()
    world1 = D.trace_cell(SMOKE, SMOKE_SHAPE, None, opt_cfg=oc)
    rec = D.cell_record(SMOKE, SMOKE_SHAPE,
                        MeshDesc(("data", "model"), (2, 4)), "fake-2x4",
                        opt_cfg=oc)
    col = rec["collectives"]
    assert col["dcn_bytes"] == 0 and col["ici_bytes"] > 0
    assert col["n_ops"] > 0 and sum(col["by_kind"].values()) == \
        col["ici_bytes"]
    assert 0 < rec["arg_bytes"] < world1.arg_bytes
    assert rec["n_devices"] == 8 and rec["path"] == "plain"
    assert rec["roofline"]["model_flops"] == pytest.approx(
        model_flops_per_step(SMOKE, SMOKE_SHAPE) / 8)
    assert set(rec) >= {"lower_s", "compile_s", "bytes_per_device",
                        "peak_temp_bytes", "output_bytes",
                        "scan_trip_counts", "sim_trace"}
    pods = MeshDesc(("pod", "data", "model"), (2, 2, 2))
    comp = D.trace_cell(SMOKE, SMOKE_SHAPE, pods, opt_cfg=oc,
                        grad_sync="compressed_pod")
    assert comp.dcn_bytes > 0 and comp.ici_bytes > 0
    assert "all-reduce" in comp.coll_by_kind
    # gspmd across pods: traced on (4, 2), the batch axis's groups span
    # both pods
    assert D.traced_desc(pods) == MeshDesc(("data", "model"), (4, 2))
    flat = D.trace_cell(SMOKE, SMOKE_SHAPE, pods, opt_cfg=oc)
    assert flat.dcn_bytes > 0 and flat.ici_bytes > 0
    topo = lovelock_cluster(8, 1, accel_rate=1.0)
    res = topo.engine().run(training_from_trace(topo, rec["sim_trace"],
                                                steps=2))
    assert res.complete and res.makespan > 0


def _whole_op_flops(cfg, shape) -> dict:
    """{axis: FLOPs} at world 1 of the ops the reference's specs leave
    whole over that axis (the only ops a rank may repeat), from their
    shapes: the expert FFNs over "data" (`moe_ecd`, `moe_ecf`: P("model",
    None, None)), the router over "model" (P(b, None)) and rwkv6's decay
    LoRA over "model" (`time_mix/w_lora`: P(b, None), P(None, b)). A train
    step runs each forward twice (remat) and its backward (two matmuls of
    the forward's size: every operand needs its gradient)."""
    N = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    D_ = cfg.d_model
    out = {"data": 0, "model": 0}
    specs = TM.block_specs(cfg)
    periods = cfg.num_layers // len(specs)
    for spec in specs:
        if spec["ffn"] == "moe":
            m = cfg.moe
            C = max(1, int(m.capacity_factor * m.top_k * N / m.num_experts))
            out["data"] += periods * 3 * 2 * m.num_experts * C * D_ * m.d_ff
            out["model"] += periods * 2 * N * D_ * m.num_experts
        if spec["kind"] == "rwkv":
            r = TS.abstract_state(cfg, OptimizerConfig(), 1).params[
                "layers"][0]["time_mix"]["w_lora"]["a"].shape[-1]
            out["model"] += periods * 2 * 2 * N * D_ * r
    mult = 4 if shape.kind == "train" else 1
    return {k: v * mult for k, v in out.items()}


@functools.cache
def _world1_flops(arch, kind, tp):
    """The world-1 step's FLOPs with heads padded for `tp` ranks."""
    return D.trace_cell(smoke_variant(tget_config(arch)),
                        ShapeConfig("smoke", 16, 8, kind), None,
                        opt_cfg=OptimizerConfig(), tp=tp).flops


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_sharded_trace_repeats_no_work(arch, kind, sizes):
    """A rank's FLOPs on a fake (data, model) mesh are the world-1 step's
    over the mesh size, plus only what the reference's specs leave whole:
    1 + sum over axes of (size - 1) x F / W within 1%, exactly 1 where
    nothing is left whole; F the world-1 FLOPs of the ops left whole over
    the axis (`_whole_op_flops`), W the world-1 total. The world-1 step
    has its heads padded as the mesh's (on (2, 4) the smoke variants' 2
    KV heads are padded to 4 to split over "model", as the reference pads
    them: 7-13% more FLOPs that no rank repeats). (Left to itself, DTensor
    carried a sublayer's partial sums into the next one, gathered the
    weights over "model" and computed them whole: 1.26x on (2, 2), 1.99x
    on (2, 4) for h2o; and the MoE, Mamba and RWKV6 blocks ran their
    routes, scans and recurrences whole on every "model" rank: 1.14-1.73x
    on (2, 2).)"""
    cfg = smoke_variant(tget_config(arch))
    shape = ShapeConfig("smoke", 16, 8, kind)
    world1 = _world1_flops(arch, kind, sizes[1])
    c = D.trace_cell(cfg, shape, MeshDesc(("data", "model"), sizes),
                     opt_cfg=OptimizerConfig())
    ratio = c.flops * math.prod(sizes) / world1
    whole = _whole_op_flops(cfg, shape)
    want = 1 + sum((n - 1) * whole[ax] / world1
                   for ax, n in zip(("data", "model"), sizes))
    if want == 1:
        assert ratio == 1.0
    assert ratio == pytest.approx(want, rel=0.01)


def test_no_state_leaks_between_cells():
    """Tracing llama4-scout's smoke prefill on (2, 2) leaves nothing that
    changes jamba's next: jamba's record (FLOPs, bytes, collectives,
    memory) is the one it gave before. (torch's DTensor caches topk's
    sharding without its k, so llama4-scout's top-1 routes once handed
    jamba's top-2 a (N, 1) shape: the port now routes per shard.)"""
    shape = ShapeConfig("smoke", 16, 8, "prefill")
    mesh = MeshDesc(("data", "model"), (2, 2))

    def record(arch):
        rec = D.cell_record(smoke_variant(tget_config(arch)), shape, mesh,
                            "fake-2x2", opt_cfg=OptimizerConfig())
        return {k: rec[k] for k in ("roofline", "collectives", "arg_bytes",
                                    "peak_temp_bytes", "output_bytes")}
    first = record("jamba-v0.1-52b")
    record("llama4-scout-17b-a16e")
    assert record("jamba-v0.1-52b") == first


@pytest.mark.parametrize("kind,batch", [("prefill", 8), ("decode", 8),
                                        ("decode", 1)])
def test_serve_cells_on_a_fake_mesh(kind, batch):
    """Prefill and decode steps trace on a fake (2, 4) mesh (params by
    param_specs, caches by cache_specs; a batch of 1 shards the cache
    over its sequence), with collectives on the ici tier only; their
    model FLOPs are the reference formula's share of a device."""
    shape = ShapeConfig(kind, 64, batch, kind)
    rec = D.cell_record(SMOKE, shape, MeshDesc(("data", "model"), (2, 4)),
                        "fake-2x4", opt_cfg=OptimizerConfig())
    col = rec["collectives"]
    assert rec["roofline"]["flops"] > 0 and col["ici_bytes"] > 0
    assert col["dcn_bytes"] == 0 and rec["arg_bytes"] > 0
    assert rec["roofline"]["model_flops"] == pytest.approx(
        model_flops_per_step(SMOKE, shape) / 8)


def test_fake_mesh_and_the_mesh_cache(tmp_path):
    """make_fake_mesh opens a fake group (device type "cpu"), reopens it at
    another size, refuses beside a real group, and the mesh cache never
    hands a fake group's mesh to a real one."""
    desc = MeshDesc(("data", "model"), (1, 1))
    fake = TMesh.make_fake_mesh(desc)
    assert dist.get_backend() == "fake" and TMesh.device_type() == "cpu"
    assert TMesh.make_fake_mesh(desc) is fake
    TMesh.make_fake_mesh(MeshDesc(("data", "model"), (2, 2)))
    assert dist.get_world_size() == 4
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    real = TMesh.make_mesh((1, 1), ("data", "model"))
    assert real is not fake and dist.get_backend() == "gloo"
    with pytest.raises(RuntimeError, match="gloo"):
        TMesh.make_fake_mesh(desc)


def test_record_keys_match_reference_dryrun():
    """The record carries every key the reference's run_cell writes, plus
    "path", "device" and "torch". The keys are read from its source: importing it
    would set XLA_FLAGS for 512 host devices in this process."""
    import pathlib
    import re
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" /
           "launch" / "dryrun.py").read_text()
    body = src[src.index("    rec = {"):src.index("    if save:")]
    want = set(re.findall(r'^\s*"(\w+)":', body, re.M)) - {
        "kind", "flops", "hbm_bytes", "tier", "bytes", "by_kind",
        "ici_bytes", "dcn_bytes", "n_ops", "n_devices", "phases"}
    rec = D.cell_record(SMOKE, SMOKE_SHAPE, None, "none",
                        opt_cfg=OptimizerConfig())
    assert want <= set(rec), want - set(rec)
    assert rec["compile_s"] == 0.0 and rec["scan_trip_counts"] == {}
    assert rec["device"] == "H100 SXM5 80GB (datasheet)"
    assert rec["torch"] == torch.__version__
    assert math.isclose(rec["roofline"]["model_flops"],
                        model_flops_per_step(SMOKE, SMOKE_SHAPE))
