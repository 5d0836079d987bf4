"""The port's training path against `repro`: cross_entropy, the cosine
schedule, int8 moments, AdamW, the train step (1 and 3 steps, with
microbatches), the copied data pipeline and straggler detector, the train
loop and its CLI. Inputs are made with numpy or by the reference and
carried across as numpy."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cfg_pair, jax_to_torch, to_np  # noqa: E402
from repro.core.elastic import StragglerDetector as JDetector  # noqa: E402
from repro.core.elastic import StragglerPolicy as JPolicy  # noqa: E402
from repro.data.pipeline import StorageNodeDataset as JDataset  # noqa: E402
from repro.launch.train import train_loop as jax_train_loop  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim.adamw import _dequant as jax_dequant  # noqa: E402
from repro.optim.adamw import _quant as jax_quant  # noqa: E402
from repro.optim.adamw import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim.schedules import cosine_schedule as jax_cosine  # noqa: E402
from repro.train import cross_entropy as jax_cross_entropy  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.core.elastic import (StragglerDetector,  # noqa: E402
                                      StragglerPolicy)
from repro_torch.data.pipeline import (Prefetcher,  # noqa: E402
                                       StorageNodeDataset)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import (OptimizerConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule)
from repro_torch.optim.adamw import _dequant, _quant  # noqa: E402
from repro_torch.train import cross_entropy, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# float32 losses of the two packages: the same sums in another order
LOSS_RTOL = 1e-5


def _state_np(state):
    return jax.tree.map(np.asarray, state)


def _assert_tree_close(got, want, atol):
    """Every leaf of the port's tree against the reference's (as numpy)."""
    want = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree.leaves(jax.tree.map(to_np, got))
    assert len(got_leaves) == len(want)
    for g, (path, w) in zip(got_leaves, want):
        np.testing.assert_allclose(g, to_np(w), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# Loss, schedule, int8 moments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("V,Vp", [(256, 256), (200, 256)])
def test_cross_entropy_matches_reference(V, Vp):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, Vp)).astype(np.float32) * 3
    logits[..., V:] += 100.0           # a padded tail must not leak in
    labels = rng.integers(0, V, (2, 5)).astype(np.int32)
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   V))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), V))
    assert got == pytest.approx(want, rel=1e-6)
    if V != Vp:                        # as tests/test_train_optim.py:57
        ref = cross_entropy(torch.from_numpy(logits[..., :V]),
                            torch.from_numpy(labels), V)
        assert got == pytest.approx(float(ref), rel=1e-6)


def test_cosine_schedule_matches_reference():
    """float32 in both packages: the same values to float32's rounding."""
    want, got = jax_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        assert got(step) == pytest.approx(float(want(jnp.asarray(step))),
                                          rel=1e-6, abs=0)
    assert got(0) == 0.0 and got(10) == pytest.approx(1e-3)
    assert got(100) == pytest.approx(1e-4, rel=0.01)


def test_quant_and_dequant_match_reference():
    """Per-row int8: the same codes (round half to even, with exact ties
    in the input), scales and dequantized values."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 64)).astype(np.float32) * 10
    x[0, 0, :4] = [127.0, 2.5, -3.5, 0.5]      # scale 1: ties at .5
    x[0, 0, 4:] = 0.0
    jq = jax_quant(jnp.asarray(x))
    tq = _quant(torch.from_numpy(x))
    np.testing.assert_array_equal(to_np(tq["q"]), np.asarray(jq["q"]))
    np.testing.assert_array_equal(to_np(tq["q"])[0, 0, :4], [127, 2, -4, 0])
    np.testing.assert_array_equal(to_np(tq["scale"]),
                                  np.asarray(jq["scale"]))
    np.testing.assert_array_equal(to_np(_dequant(tq)),
                                  np.asarray(jax_dequant(jq, x.shape)))
    err = np.abs(to_np(_dequant(tq)) - x) / np.abs(x).max(-1, keepdims=True)
    assert err.max() <= 1.0 / 127 / 2 + 1e-6


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _toy_params(dtype):
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((8, 16)), "layers": [
        {"b": rng.standard_normal((16,)), "a": rng.standard_normal((4, 8))}]}
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("state_dtype,param_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("int8", "float32")])
def test_adamw_update_matches_reference(state_dtype, param_dtype):
    """Three updates from the same state and gradients (the second clipped
    by the global norm). float32 state: params, moments and master agree
    to 1e-6 (float32 rounding of a 1e-2 step); bf16 params to one bf16
    ulp of |p| < 4 (2^-6). int8 moments: the codes may differ by one where
    a value sits on a rounding boundary."""
    oc = JOptimizerConfig(lr=1e-2, state_dtype=state_dtype,
                          master=state_dtype == "float32", warmup=2,
                          total_steps=10, grad_clip=2.0)
    tc = OptimizerConfig(**{f: getattr(oc, f) for f in
                            oc.__dataclass_fields__})
    jstate = jax_adamw_init(_toy_params(getattr(jnp, param_dtype)), oc)
    tstate = train_state_from_numpy(_state_np(jstate))
    jlr, tlr = (jax_cosine(oc.lr, oc.warmup, oc.total_steps),
                cosine_schedule(oc.lr, oc.warmup, oc.total_steps))
    rng = np.random.default_rng(3)
    for scale in (0.1, 10.0, 0.5):
        g = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale,
                                  p.dtype), jstate.params)
        jstate = jax_adamw_update(jstate, g, oc, jlr)
        tstate = adamw_update(tstate, jax_to_torch(g), tc, tlr)
    assert tstate.step == int(jstate.step) == 3
    p_tol = 2.0 ** -6 if param_dtype == "bfloat16" else 1e-6
    _assert_tree_close(tstate.params, jstate.params, p_tol)
    if state_dtype == "float32":
        for name in ("m", "v", "master"):
            _assert_tree_close(getattr(tstate, name), getattr(jstate, name),
                               1e-6)
        return
    assert tstate.master is None

    def part(tree, key):
        return jax.tree.map(lambda d: d[key], tree,
                            is_leaf=lambda x: isinstance(x, dict) and "q" in x)
    for name in ("m", "v"):
        got, want = getattr(tstate, name), getattr(jstate, name)
        _assert_tree_close(part(got, "q"), part(want, "q"), 1)
        _assert_tree_close(part(got, "scale"), part(want, "scale"), 1e-6)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _batch(seed, B, S, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1),
                                                dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ["lovelock-20m", "rwkv6-7b"])
def test_train_step_matches_reference(arch, use_kernels, microbatches):
    """1 and 3 steps from the same TrainState, float32 smoke models: the
    losses agree to 1e-5 relative and the params after 3 steps to 2e-5
    (three steps of at most lr = 1e-3 each, float32 gradients that agree
    to ~1e-6 relative)."""
    jc, tc = cfg_pair(arch, smoke=True)
    oc = JOptimizerConfig(lr=1e-3, warmup=2, total_steps=10)
    tc_opt = OptimizerConfig(lr=1e-3, warmup=2, total_steps=10)
    jstate = jax_adamw_init(JM.init_params(jax.random.PRNGKey(0), jc), oc)
    tstate = train_state_from_numpy(_state_np(jstate))
    jstep = jax.jit(jax_make_train_step(jc, oc, microbatches=microbatches))
    tstep = make_train_step(tc, tc_opt, use_kernels=use_kernels,
                            microbatches=microbatches)
    for i in range(3):
        batch = _batch(10 + i, 4, 16, jc.vocab_size)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=LOSS_RTOL)
    assert tstate.step == 3
    _assert_tree_close(tstate.params, jstate.params, 2e-5)
    _assert_tree_close(tstate.master, jstate.master, 2e-5)


def test_microbatch_accumulation_matches_full_batch():
    """As tests/test_optimizations.py:79, on the port alone."""
    _, tc = cfg_pair("qwen3-32b", smoke=True, f32=False)
    oc = OptimizerConfig(lr=1e-3)
    batch = _torch_batch(_batch(1, 8, 16, tc.vocab_size))
    outs = {}
    for k in (1, 4):
        params = TM.init_params(torch.Generator().manual_seed(0), tc)
        state = adamw_init(params, oc)
        step = make_train_step(tc, oc, microbatches=k)
        for _ in range(3):
            state, m = step(state, batch)
        outs[k] = float(m["loss"])
    assert abs(outs[1] - outs[4]) < 0.02, outs


def test_loss_decreases_on_repeated_batch():
    """As tests/test_train_optim.py:14, on the port's rwkv6-7b smoke."""
    _, tc = cfg_pair("rwkv6-7b", smoke=True, f32=False)
    oc = OptimizerConfig(lr=1e-3)
    state = adamw_init(TM.init_params(torch.Generator().manual_seed(0), tc),
                       oc)
    step = make_train_step(tc, oc)
    batch = _torch_batch(_batch(1, 2, 32, tc.vocab_size))
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05, losses


def test_grad_clip_applied():
    """As tests/test_train_optim.py:79: clipped to ~zero, the step moves
    the params by the weight decay only."""
    _, tc = cfg_pair("qwen3-32b", smoke=True, f32=False)
    oc = OptimizerConfig(lr=1.0, grad_clip=1e-9)
    state = adamw_init(TM.init_params(torch.Generator().manual_seed(0), tc),
                       oc)
    before = state.params["embed"].float().clone()
    state, _ = make_train_step(tc, oc)(state, _torch_batch(
        _batch(1, 2, 16, tc.vocab_size)))
    assert (state.params["embed"].float() - before).abs().max() < 1e-2


def test_int8_state_tracks_fp32():
    """As tests/test_train_optim.py:29, on the port alone."""
    _, tc = cfg_pair("qwen3-32b", smoke=True, f32=False)
    batch = _torch_batch(_batch(1, 2, 16, tc.vocab_size))
    outs = {}
    for sd in ("float32", "int8"):
        oc = OptimizerConfig(lr=1e-3, state_dtype=sd,
                             master=sd == "float32")
        state = adamw_init(
            TM.init_params(torch.Generator().manual_seed(0), tc), oc)
        step = make_train_step(tc, oc)
        for _ in range(8):
            state, m = step(state, batch)
        outs[sd] = float(m["loss"])
    assert abs(outs["int8"] - outs["float32"]) < 0.15, outs


def test_compressed_pod_without_a_pod_axis_is_gspmd():
    """Without rules (one device) grad_sync='compressed_pod' is the gspmd
    step, as in the reference (src/repro/train/steps.py:94-96): the same
    losses and params bit for bit; the ef is carried through untouched.
    An unknown sync raises."""
    _, tc = cfg_pair("lovelock-20m", smoke=True)
    oc = OptimizerConfig(lr=1e-3, warmup=2, total_steps=10)
    out = {}
    for mode in ("gspmd", "compressed_pod"):
        state = adamw_init(TM.init_params(torch.Generator().manual_seed(0),
                                          tc), oc, with_ef=True)
        step = make_train_step(tc, oc, grad_sync=mode)
        losses = []
        for i in range(2):
            state, m = step(state, _torch_batch(_batch(i, 4, 16,
                                                       tc.vocab_size)))
            losses.append(float(m["loss"]))
        out[mode] = (losses, state)
    assert out["gspmd"][0] == out["compressed_pod"][0]
    for a, b in zip(tree_leaves(out["gspmd"][1].params),
                    tree_leaves(out["compressed_pod"][1].params)):
        assert torch.equal(a, b)
    assert all(float(e.abs().max()) == 0
               for e in tree_leaves(out["compressed_pod"][1].ef))
    with pytest.raises(ValueError, match="grad_sync"):
        make_train_step(tc, oc, grad_sync="ring")


# ---------------------------------------------------------------------------
# Data pipeline and straggler detection (copies of numpy-only modules)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distribution", ["uniform", "zipf_markov"])
def test_data_pipeline_matches_reference(distribution):
    kw = dict(vocab_size=300, seq_len=24, global_batch=8, seed=5,
              distribution=distribution)
    want, got = JDataset(**kw), StorageNodeDataset(**kw)
    for step in range(3):
        a, b = want.fetch_step(step), got.fetch_step(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="storage nodes"):
        StorageNodeDataset(vocab_size=10, seq_len=4, global_batch=6)


def test_prefetcher_keeps_order_and_closes():
    ds = StorageNodeDataset(vocab_size=50, seq_len=8, global_batch=4)
    it = Prefetcher(iter(ds), depth=2)
    for step, batch in zip(range(4), it):
        np.testing.assert_array_equal(batch["tokens"],
                                      ds.fetch_step(step)["tokens"])
    it.close()
    assert not it.t.is_alive()


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(4)
    policy = dict(deadline_factor=1.5, patience=2, ewma=0.5)
    want = JDetector(4, JPolicy(**policy))
    got = StragglerDetector(4, StragglerPolicy(**policy))
    for step in range(12):
        t = 1.0 + 0.05 * rng.random(4)
        if step >= 4:
            t[2] *= 3.0                      # host 2 turns slow
        if step == 6:
            t[1] = np.nan                    # host 1 misses a report
        assert got.observe(t) == want.observe(t)
        np.testing.assert_array_equal(got.strikes, want.strikes)
        np.testing.assert_allclose(got.est, want.est, rtol=0, atol=0)
    assert 2 in got.observe(t)


# ---------------------------------------------------------------------------
# The train loop and its CLI
# ---------------------------------------------------------------------------


def test_train_loop_matches_reference():
    """The whole loop (data, steps, AdamW) from the reference's own
    initial params, float32 lovelock-20m smoke: the same losses."""
    jc, tc = cfg_pair("lovelock-20m", smoke=True)
    kw = dict(steps=4, batch=4, seq=16, seed=3, log_every=100)
    _, jinfo = jax_train_loop(jc, **kw)
    params = jax_to_torch(JM.init_params(jax.random.PRNGKey(3), jc, tp=1))
    state, info = ttrain.train_loop(tc, device="cpu", params=params, **kw)
    assert state.step == 4 and len(info["step_s"]) == 4
    np.testing.assert_allclose(info["losses"], jinfo["losses"],
                               rtol=LOSS_RTOL)
    assert all(s > 0 for s in info["step_s"]) and info["wall_s"] > 0


def test_train_loop_defaults_to_the_card():
    """No card here: the default device raises rather than using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = cfg_pair("lovelock-20m", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train_loop(tc, steps=1, batch=4, seq=8)


@pytest.mark.parametrize("arch", ["lovelock-20m", "rwkv6-7b"])
def test_cli_runs_on_cpu_with_jax_and_repro_blocked(arch, tmp_path):
    """`python -m repro_torch.launch.train --smoke --device cpu` with jax
    and repro blocked from import."""
    log = tmp_path / "train.jsonl"
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {str(SRC)!r})
sys.argv = ["train", "--arch", {arch!r}, "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16",
            "--log", {str(log)!r}]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: 3 steps" in res.stdout
    assert '"step": 0' in log.read_text()


def test_train_state_from_numpy():
    """The reference's TrainState carried across: float32 and int8, and
    with the error feedback `ef` (bf16, like the params)."""
    for sd in ("float32", "int8"):
        oc = JOptimizerConfig(state_dtype=sd, master=sd == "float32")
        jstate = jax_adamw_init(_toy_params(jnp.bfloat16), oc)
        state = train_state_from_numpy(_state_np(jstate))
        assert state.step == 0
        assert state.params["w"].dtype == torch.bfloat16
        if sd == "int8":
            assert state.master is None
            assert state.m["w"]["q"].dtype == torch.int8
            assert state.m["w"]["scale"].shape == (8,)
        else:
            assert state.master["w"].dtype == torch.float32
    jstate = jax_adamw_init(_toy_params(jnp.float32), JOptimizerConfig(),
                            with_ef=True)
    rng = np.random.default_rng(5)
    jstate = jstate._replace(ef=jax.tree.map(
        lambda e: jnp.asarray(rng.standard_normal(e.shape), jnp.bfloat16),
        jstate.ef))
    state = train_state_from_numpy(_state_np(jstate))
    assert state.ef["w"].dtype == torch.bfloat16
    _assert_tree_close(state.ef, jstate.ef, 0)
    ported = adamw_init(train_state_from_numpy(_state_np(jstate)).params,
                        OptimizerConfig(), with_ef=True)
    assert [(t.dtype, t.shape) for t in tree_leaves(ported.ef)] == \
        [(t.dtype, t.shape) for t in tree_leaves(state.ef)]


@pytest.mark.parametrize("arch", ["lovelock-20m", "rwkv6-7b"])
def test_bf16_train_step_tracks_reference(arch):
    """bf16 smoke models (bf16 weights and activations, float32 master and
    moments, the WKV recurrence in float32): 3 steps from the same state.
    Each package rounds to bf16 at its own places (the losses differed by
    up to 2e-5 relative when this was written), so they are held to 1e-3
    relative."""
    jc, tc = cfg_pair(arch, smoke=True, f32=False)
    oc = JOptimizerConfig(lr=1e-3, warmup=2, total_steps=10)
    jstate = jax_adamw_init(JM.init_params(jax.random.PRNGKey(0), jc), oc)
    tstate = train_state_from_numpy(_state_np(jstate))
    jstep = jax.jit(jax_make_train_step(jc, oc))
    tstep = make_train_step(tc, OptimizerConfig(lr=1e-3, warmup=2,
                                                total_steps=10))
    for i in range(3):
        batch = _batch(20 + i, 4, 32, jc.vocab_size)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, _torch_batch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-3)
    assert tstate.params["embed"].dtype == torch.bfloat16
    assert tstate.master["embed"].dtype == torch.float32
