"""The port's sharding rules against `repro.sharding.rules`: param, state
(float32 and int8) and cache specs, spec for spec, for every `ALL_ARCHS`
entry on the production mesh descriptions (16, 16) and (2, 16, 16), and
the activation table. The port's trees are its dry-run's abstract trees
(`repro_torch.train.steps.abstract_state` / `abstract_caches`, FakeTensors:
shapes only), the reference's by `jax.eval_shape`; no devices or ranks are
needed."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro.configs import supports_shape  # noqa: E402
from repro.launch.mesh import make_abstract_mesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.sharding.rules import ShardingRules as JRules  # noqa: E402
from repro.sharding.rules import param_specs as jparam_specs  # noqa: E402
from repro.sharding.rules import state_specs as jstate_specs  # noqa: E402
from repro.train.steps import abstract_caches, abstract_state  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.core.streaming_checkpoint import _leaf_paths  # noqa: E402
from repro_torch.launch.mesh import (MeshDesc, mesh_axes,  # noqa: E402
                                     production_mesh_desc)
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.sharding.rules import (ShardingRules, Spec,  # noqa: E402
                                        param_specs, state_specs)
from repro_torch.train import steps as TS  # noqa: E402

MESHES = {"single": (make_abstract_mesh((16, 16), ("data", "model")),
                     production_mesh_desc()),
          "multi": (make_abstract_mesh((2, 16, 16), ("pod", "data",
                                                      "model")),
                    production_mesh_desc(multi_pod=True))}
OPTS = {"float32": dict(), "int8": dict(state_dtype="int8", master=False)}


@functools.cache
def _jax_state(arch, sd):
    return abstract_state(get_config(arch), JOptimizerConfig(**OPTS[sd]), 16)


@functools.cache
def _torch_state(arch, sd):
    return TS.abstract_state(tget_config(arch), OptimizerConfig(**OPTS[sd]),
                             16)


def spec_leaves(tree) -> list:
    """The `Spec`s of a port spec tree in `_leaf_paths` order (dict keys
    sorted); None is an empty subtree."""
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):       # lists and TrainStates
        return [s for t in tree for s in spec_leaves(t)]
    return []


def _jax_specs(tree, specs):
    """[(path, spec as a tuple)] of a reference tree and its specs."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sleaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(sleaves)
    return [("/".join(str(getattr(k, "key", getattr(k, "idx",
                                                    getattr(k, "name", k))))
                      for k in path), tuple(s))
            for (path, _), s in zip(leaves, sleaves)]


def _torch_specs(tree, specs):
    """[(path, spec as a tuple)] of a port tree (int leaves included) and
    its specs."""
    paths = [p for p, _ in _leaf_paths(tree)]
    sleaves = spec_leaves(specs)
    assert len(paths) == len(sleaves)
    assert all(isinstance(s, Spec) for s in sleaves)
    return [(p, tuple(s)) for p, s in zip(paths, sleaves)]


def _check_divisible(tree, specs, mesh: MeshDesc):
    """As tests/test_sharding.py:_check_divisible, on the port's trees."""
    for (path, leaf), spec in zip(_leaf_paths(tree), spec_leaves(specs)):
        shape = () if isinstance(leaf, int) else tuple(leaf.shape)
        assert len(spec) == len(shape), path
        for dim, ax in zip(shape, spec):
            axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            assert dim % size == 0, (path, shape, spec)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_state_specs_match_reference(arch, mesh):
    """param_specs and state_specs (float32 with master, int8 without)
    equal the reference's spec for spec, with the same leaf paths; the
    specs divide their dims."""
    jmesh, tmesh = MESHES[mesh]
    for sd in ("float32", "int8"):
        jstate, tstate = _jax_state(arch, sd), _torch_state(arch, sd)
        if sd == "float32":
            want = _jax_specs(jstate.params,
                              jparam_specs(jstate.params, jmesh))
            got = _torch_specs(tstate.params,
                               param_specs(tstate.params, tmesh))
            assert got == want
        for fsdp_pod in (True, False):
            want = _jax_specs(jstate, jstate_specs(jstate, jmesh,
                                                   fsdp_pod=fsdp_pod))
            specs = state_specs(tstate, tmesh, fsdp_pod=fsdp_pod)
            assert _torch_specs(tstate, specs) == want
            _check_divisible(tstate, specs, tmesh)


def test_state_specs_with_ef_match_reference():
    """The `ef` leaf's specs are the params' (both meshes)."""
    arch = "h2o-danube-1.8b"
    jstate = abstract_state(get_config(arch), JOptimizerConfig(), 16,
                            with_ef=True)
    tstate = TS.abstract_state(tget_config(arch), OptimizerConfig(), 16,
                               with_ef=True)
    for jmesh, tmesh in MESHES.values():
        for fsdp_pod in (True, False):
            want = _jax_specs(jstate, jstate_specs(jstate, jmesh,
                                                   fsdp_pod=fsdp_pod))
            got = _torch_specs(tstate, state_specs(tstate, tmesh,
                                                   fsdp_pod=fsdp_pod))
            assert got == want
            assert any(p.startswith("ef/") for p, _ in got)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    """cache_specs at decode_32k and long_500k (where the arch supports
    the shape; batch < 16 seq-shards) equal the reference's."""
    jmesh, tmesh = MESHES[mesh]
    jcfg, tcfg = get_config(arch), tget_config(arch)
    for name in ("decode_32k", "long_500k"):
        sh = SHAPES[name]
        if not supports_shape(jcfg, sh)[0]:
            continue
        seq = sh.global_batch < 16
        jc = abstract_caches(jcfg, sh, 16)
        tc = TS.abstract_caches(tcfg, TSHAPES[name], 16)
        want = _jax_specs(jc, JRules(jmesh, seq_sharded=seq).cache_specs(jc))
        specs = ShardingRules(tmesh, seq_sharded=seq).cache_specs(tc)
        assert _torch_specs(tc, specs) == want
        _check_divisible(tc, specs, tmesh)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_rules_table_matches_reference(mesh):
    jmesh, tmesh = MESHES[mesh]
    for kw in ({}, {"seq_sharded": True}, {"exclude_pod": True}):
        want, got = JRules(jmesh, **kw), ShardingRules(tmesh, **kw)
        assert {k: tuple(v) for k, v in got.table.items()} == \
            {k: tuple(v) for k, v in want.table.items()}
        assert got.batch_axes == want.batch_axes
        assert tuple(got.batch_sharding()) == tuple(want.batch_sharding()
                                                    .spec)
        assert not got.live
    # a spec-only mesh constrains nothing
    x = torch.zeros(32, 4, 8)
    assert ShardingRules(tmesh).cs(x, "act_bsd") is x


def test_mesh_axes_and_descriptions():
    from repro.launch.mesh import mesh_axes as jmesh_axes
    for jmesh, tmesh in MESHES.values():
        assert tmesh.axis_names == tuple(jmesh.axis_names)
        assert mesh_axes(tmesh) == jmesh_axes(jmesh)
    assert production_mesh_desc(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}


def test_tp_weight_sharding_covers_big_tensors():
    """As tests/test_sharding.py: every >= 1M-element param of llama3-405b
    is sharded at least 16 ways on the single-pod mesh."""
    mesh = production_mesh_desc()
    params = _torch_state("llama3-405b", "float32").params
    for (path, leaf), spec in zip(_leaf_paths(params),
                                  spec_leaves(param_specs(params, mesh))):
        if leaf.numel() >= 2 ** 20:
            total = 1
            for ax in spec:
                for a in (ax if isinstance(ax, tuple)
                          else ((ax,) if ax else ())):
                    total *= mesh.shape[a]
            assert total >= 16, (path, spec)
