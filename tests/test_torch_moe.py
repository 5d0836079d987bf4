"""The port's MoE FFN (`_moe_route`, `_moe_aux`, `moe_ffn` with both
dispatch paths) and the MoE / hybrid models (llama4-scout, kimi-k2,
jamba) against `repro`, on the same numpy inputs. Float32 throughout
unless a test says otherwise."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (LOGIT_TOL_BF16, LOGIT_TOL_F32, cfg_pair,  # noqa: E402
                           jax_to_torch, to_np)
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.convert import (caches_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

GATE_TOL = 1e-6          # renormalised float32 softmax probabilities
FFN_TOL = 1e-5           # float32 MoE outputs
LOSS_RTOL = 1e-5         # float32 losses, as tests/test_torch_train.py
ARCHS = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-v0.1-52b"]

# N tokens, D, E experts, top-k, expert F, skew (a router bias toward
# expert 0 that overflows its capacity), shared experts
ROUTES = {
    "balanced": (32, 16, 4, 2, 24, 0.0, 0),
    "overflow": (48, 16, 4, 2, 24, 4.0, 0),
    "decode_C1": (4, 16, 16, 2, 24, 0.0, 0),      # C = max(1, 0) = 1
    "top1_shared": (40, 16, 8, 1, 24, 1.0, 1),
    "top8_shared": (64, 16, 16, 8, 24, 0.5, 1),
}


def _moe_inputs(seed, N, D, E, K, Fd, skew, shared):
    """x (N,D); params with a float32 router whose column 0 is pulled
    toward a direction common to the tokens by `skew` (with skew 0 the
    tokens share none)."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(D).astype(np.float32)
    x = (rng.standard_normal((N, D)) + (common if skew else 0.0)).astype(
        np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32) * 0.3
    router[:, 0] += skew * common / np.linalg.norm(common) ** 2
    p = {"router": router,
         "w_gate": rng.standard_normal((E, D, Fd)).astype(np.float32) * 0.2,
         "w_up": rng.standard_normal((E, D, Fd)).astype(np.float32) * 0.2,
         "w_down": rng.standard_normal((E, Fd, D)).astype(np.float32) * 0.2}
    if shared:
        p["shared"] = {
            "w_gate": rng.standard_normal((D, Fd)).astype(np.float32) * 0.2,
            "w_up": rng.standard_normal((D, Fd)).astype(np.float32) * 0.2,
            "w_down": rng.standard_normal((Fd, D)).astype(np.float32) * 0.2}
    return x, p


def _cfgs(E, K, Fd, shared, dispatch="einsum"):
    kw = dict(num_experts=E, top_k=K, d_ff=Fd, num_shared_experts=shared,
              dispatch=dispatch)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _tparams(p):
    return jax.tree.map(torch.from_numpy, p)


@pytest.mark.parametrize("case", list(ROUTES), ids=list(ROUTES))
def test_moe_route_matches_reference(case):
    """Gates to 1e-6; expert ids, slot positions, keep and C exactly."""
    N, D, E, K, Fd, skew, shared = ROUTES[case]
    x, p = _moe_inputs(0, N, D, E, K, Fd, skew, shared)
    jcfg, tcfg = _cfgs(E, K, Fd, shared)
    jg, jids, jpos, jC, jprobs = JL._moe_route(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    tg, tids, tpos, tC, tprobs = TL._moe_route(_tparams(p),
                                               torch.from_numpy(x), tcfg)
    assert tC == jC == max(1, int(1.25 * K * N / E))
    np.testing.assert_array_equal(to_np(tids), np.asarray(jids))
    np.testing.assert_array_equal(to_np(tpos), np.asarray(jpos))
    np.testing.assert_array_equal(to_np(tg) > 0, np.asarray(jg) > 0)
    np.testing.assert_allclose(to_np(tg), np.asarray(jg), atol=GATE_TOL,
                               rtol=0)
    np.testing.assert_allclose(to_np(tprobs), np.asarray(jprobs),
                               atol=GATE_TOL, rtol=0)
    dropped = int((to_np(tpos) >= tC).sum())
    if case in ("overflow", "decode_C1"):
        assert dropped > 0, "the case must overflow an expert's capacity"
    if case == "balanced":
        assert dropped == 0


@pytest.mark.parametrize("case", ["balanced", "overflow", "top8_shared"])
def test_moe_aux_matches_reference(case):
    N, D, E, K, Fd, skew, shared = ROUTES[case]
    x, p = _moe_inputs(1, N, D, E, K, Fd, skew, shared)
    jcfg, tcfg = _cfgs(E, K, Fd, shared)
    _, jids, _, _, jprobs = JL._moe_route(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x), jcfg)
    _, tids, _, _, tprobs = TL._moe_route(_tparams(p), torch.from_numpy(x),
                                          tcfg)
    want = float(JL._moe_aux(jids, jprobs, jcfg))
    got = float(TL._moe_aux(tids, tprobs, tcfg))
    assert got == pytest.approx(want, rel=1e-6) and got > 0


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("case", list(ROUTES), ids=list(ROUTES))
def test_moe_ffn_matches_reference(case, dispatch):
    """Both dispatch paths, with and without shared experts, overflow
    included: outputs to 1e-5, aux to 1e-6 relative."""
    N, D, E, K, Fd, skew, shared = ROUTES[case]
    x, p = _moe_inputs(2, N, D, E, K, Fd, skew, shared)
    x = x.reshape(2, N // 2, D)
    jcfg, tcfg = _cfgs(E, K, Fd, shared, dispatch)
    jo, jaux = JL.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg)
    to, taux = TL.moe_ffn(_tparams(p), torch.from_numpy(x), tcfg)
    assert to.shape == x.shape
    np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=FFN_TOL,
                               rtol=0)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_dispatch_paths_agree_and_drop_overflow():
    """einsum and scatter compute the same function on the port; a token
    whose every choice overflowed gets the shared experts' output only."""
    N, D, E, K, Fd, skew, _ = ROUTES["overflow"]
    x, p = _moe_inputs(3, N, D, E, K, Fd, skew, 0)
    xt = torch.from_numpy(x)[None]
    outs = [TL.moe_ffn(_tparams(p), xt, _cfgs(E, K, Fd, 0, d)[1])[0]
            for d in ("einsum", "scatter")]
    np.testing.assert_allclose(to_np(outs[0]), to_np(outs[1]), atol=FFN_TOL,
                               rtol=0)
    gates, *_ = TL._moe_route(_tparams(p), torch.from_numpy(x),
                              _cfgs(E, K, Fd, 0)[1])
    gone = (gates == 0).all(-1)
    assert gone.any()
    assert (outs[0][0][gone] == 0).all()
    with pytest.raises(ValueError, match="dispatch"):
        TL.moe_ffn(_tparams(p), xt, _cfgs(E, K, Fd, 0, "ragged")[1])


# ---------------------------------------------------------------------------
# The MoE and hybrid models
# ---------------------------------------------------------------------------


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


@functools.cache
def _setup(arch, f32=True):
    jc, tc = cfg_pair(arch, smoke=True, f32=f32)
    jparams = _jax_init(jax.random.PRNGKey(0), jc, 1)
    return jc, tc, jparams, jax_to_torch(jparams)


_jax_init = jax.jit(JM.init_params, static_argnums=(1, 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Logits to 1e-4 and the aux loss (summed over the MoE blocks) to
    1e-6 relative, through the kernel and the plain path."""
    jc, tc, jparams, tparams = _setup(arch)
    toks = _tokens(1, 2, 16, jc.vocab_size)
    want, jaux, _ = JM.forward(jparams, jc, toks, remat=False)
    for use_kernels in (True, False):
        got, aux, _ = TM.forward(tparams, tc, torch.from_numpy(toks),
                                 use_kernels=use_kernels)
        np.testing.assert_allclose(to_np(got), to_np(want),
                                   atol=LOGIT_TOL_F32, rtol=0)
        assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
        assert float(aux) > 0


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-v0.1-52b"])
def test_scatter_dispatch_model_matches_reference(arch, dispatch):
    """dispatch is a field of MoEConfig that no config sets to 'scatter':
    both paths through the whole model, against the reference's."""
    jc, tc, jparams, tparams = _setup(arch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                         dispatch=dispatch))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         dispatch=dispatch))
    toks = _tokens(7, 2, 32, jc.vocab_size)
    want, jaux, _ = JM.forward(jparams, jc, toks, remat=False)
    got, aux, _ = TM.forward(tparams, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=LOGIT_TOL_F32,
                               rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill into float32 caches, then decode 3 tokens: logits at 1e-4
    at every step under both of the reference's decode branches, and the
    caches (KV, Mamba conv and SSM states) after the last step."""
    jc, tc, jparams, tparams = _setup(arch)
    B, S, P = 2, 12, 9
    toks = _tokens(2, B, S, jc.vocab_size)
    jcache = JM.init_caches(jc, B, S, tp=1, dtype=jnp.float32)
    tcache = TM.init_caches(tc, B, S, tp=1, dtype=torch.float32,
                            device="cpu")
    assert jax.tree.map(np.shape, jcache["layers"]) == jax.tree.map(
        np.shape, jax.tree.map(to_np, tcache["layers"]))
    jl, _, jcache = JM.forward(jparams, jc, toks[:, :P], caches=jcache,
                               remat=False)
    tl, _, tcache = TM.forward(tparams, tc, torch.from_numpy(toks[:, :P]),
                               caches=tcache)
    np.testing.assert_allclose(to_np(tl), to_np(jl), atol=LOGIT_TOL_F32,
                               rtol=0)
    jcaches = {False: jcache, True: jcache}
    for t in range(P, S):
        tl, tcache = TM.decode_step(tparams, tc,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    tcache)
        for carry in jcaches:
            jl, jcaches[carry] = JM.decode_step(
                jparams, jc, toks[:, t:t + 1], jcaches[carry],
                cache_in_carry=carry)
            np.testing.assert_allclose(to_np(tl), to_np(jl),
                                       atol=LOGIT_TOL_F32, rtol=0)
    want = caches_from_numpy(jax.tree.map(np.asarray, jcaches[True]))
    assert want["index"] == tcache["index"] == S
    for w, g in zip(jax.tree.leaves(want["layers"]),
                    jax.tree.leaves(jax.tree.map(to_np, tcache["layers"]))):
        np.testing.assert_allclose(g, to_np(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher forcing on the port alone, bf16, as tests/test_models.py:60
    does for jamba: prefill + decode logits within the reference's 0.15 of
    the full forward's (decode routes 2 tokens at a time, so its capacity
    differs from the forward's)."""
    _, tc = cfg_pair(arch, smoke=True, f32=False)
    params = TM.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.from_numpy(_tokens(4, 2, 12, tc.vocab_size))
    full, _, _ = TM.forward(params, tc, toks)
    caches = TM.init_caches(tc, 2, 12, device="cpu")
    _, _, caches = TM.forward(params, tc, toks[:, :8], caches=caches)
    errs = []
    for t in range(8, 12):
        lg, caches = TM.decode_step(params, tc, toks[:, t:t + 1], caches)
        errs.append(float((lg[:, 0].float() - full[:, t].float()).abs()
                          .max()))
    assert max(errs) < LOGIT_TOL_BF16, errs


def test_block_structure_matches_reference():
    """period_of and block_specs for every family the port runs."""
    from repro.configs import ALL_ARCHS
    for arch in ALL_ARCHS:
        jc, tc = cfg_pair(arch, smoke=True)
        if jc.cross_attn_every or jc.encoder_layers:
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                TM.block_specs(tc)
            continue
        assert TM.period_of(tc) == JM.period_of(jc), arch
        assert TM.block_specs(tc) == JM.block_specs(jc), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_layout(arch):
    """Same tree, shapes, dtypes and scales as the reference (bf16
    weights, a float32 router and A_log), not values."""
    jc, tc, jparams, _ = _setup(arch, f32=False)
    got = TM.init_params(torch.Generator().manual_seed(0), tc)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(want) == len(jax.tree.leaves(jax.tree.map(to_np, got)))
    for path, leaf in want:
        t = got
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        a, b = np.asarray(leaf).astype(np.float32), to_np(t)
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        assert str(leaf.dtype) == str(t.dtype).removeprefix("torch."), name
        np.testing.assert_array_equal(a == 0, b == 0)
        if a.std() > 0 and "A_log" not in name:
            # two sample stds of n values: their ratio's relative spread is
            # ~1/sqrt(n); five of those, and at least the 5% of
            # tests/test_torch_model.py
            tol = max(0.05, 5 / np.sqrt(a.size))
            assert abs(b.std() / a.std() - 1) < tol, name
        else:                              # constants: equal
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("steps", [1, 3])
def test_jamba_train_step_matches_reference(steps):
    """jamba smoke in float32 (Mamba, MoE with its aux loss in the
    gradient, one attention layer): 1 and 3 steps from the same TrainState,
    losses and aux to 1e-5 relative, params after the steps to 2e-5."""
    jc, tc = cfg_pair("jamba-v0.1-52b", smoke=True)
    oc = dict(lr=1e-3, warmup=2, total_steps=10)
    jstate = jax_adamw_init(JM.init_params(jax.random.PRNGKey(0), jc),
                            JOptimizerConfig(**oc))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jax_make_train_step(jc, JOptimizerConfig(**oc)))
    tstep = make_train_step(tc, OptimizerConfig(**oc))
    rng = np.random.default_rng(11)
    for _ in range(steps):
        toks = rng.integers(0, jc.vocab_size, (4, 17), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=LOSS_RTOL)
        assert float(tm["aux"]) == pytest.approx(float(jm["aux"]),
                                                 rel=LOSS_RTOL)
        assert float(tm["aux"]) > 0
    assert tstate.step == steps
    for g, w in zip(jax.tree.leaves(jax.tree.map(to_np, tstate.params)),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(g, to_np(w), atol=2e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_reference(arch):
    """The serve entry point, float32 smoke: prompt 12, 6 tokens, the same
    greedy tokens as the reference's serve on its weights and prompts."""
    from repro.launch.serve import serve as jax_serve
    from repro_torch.launch.serve import serve
    jc, tc, jparams, tparams = _setup(arch)
    B, P, G, seed = 2, 12, 6, 0
    want, _ = jax_serve(jc, batch=B, prompt_len=P, gen=G, seed=seed)
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(seed + 1),
                                          (B, P), 0, jc.vocab_size))
    got, _, logits = serve(tc, batch=B, prompt_len=P, gen=G, device="cpu",
                           params=tparams, prompts=torch.from_numpy(prompts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isfinite(logits).all()


def test_serve_cli_cuts_jamba_to_one_period(monkeypatch, capsys):
    """`--layers 8` of jamba's smoke variant: one period, on the CPU."""
    import sys
    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "jamba-v0.1-52b", "--smoke", "--layers", "8",
        "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    tserve.main()
    assert "generated shape: (2, 3)" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "jamba-v0.1-52b", "--smoke", "--layers", "12",
        "--device", "cpu", "--batch", "1", "--prompt-len", "4", "--gen", "2"])
    with pytest.raises(ValueError, match="period"):
        tserve.main()


def test_convert_moe_and_mamba_leaves():
    """The reference's jamba and kimi params convert leaf by leaf: the same
    paths, dtypes (bf16 through float32, exact) and values."""
    for arch in ("jamba-v0.1-52b", "kimi-k2-1t-a32b"):
        _, _, jparams, tparams = _setup(arch, f32=False)
        want = jax.tree_util.tree_flatten_with_path(jparams)[0]
        got = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t, tparams))[0]
        assert [jax.tree_util.keystr(p) for p, _ in want] == [
            jax.tree_util.keystr(p) for p, _ in got]
        for (path, w), (_, g) in zip(want, got):
            assert str(w.dtype) == str(g.dtype).removeprefix("torch.")
            np.testing.assert_array_equal(to_np(g), to_np(w),
                                          err_msg=jax.tree_util.keystr(path))
