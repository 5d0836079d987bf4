"""The port's RWKV6 (Finch) slice against `repro`: the WKV6 kernel's plain
version and wrapper with its gradient, the RWKV6 layers and the rwkv6-7b
model, on the same numpy inputs.

On the CPU the wrapper `wkv6` runs its plain version; the reference runs
its Pallas kernel in interpret mode. The CUDA kernel itself is tested on
the card by tests/test_torch_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (LOGIT_TOL_BF16, LOGIT_TOL_F32, WKV6_SWEEP,  # noqa: E402
                           WKV6_TOL, both, cfg_pair, jax_to_torch, to_np,
                           wkv6_inputs)
from repro.kernels.rwkv6 import wkv6 as jax_wkv6  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.convert import caches_from_numpy  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6 import wkv6, wkv6_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

# float32 layers: the WKV recurrence carries a state over the sequence, so
# the layer outputs are held to the recurrence's tolerance
LAYER_TOL = WKV6_TOL


def _close(a, b, tol=WKV6_TOL):
    np.testing.assert_allclose(to_np(a), to_np(b), atol=tol, rtol=0)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# The WKV6 kernel's plain version and wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,S,d", WKV6_SWEEP)
def test_wkv6_matches_reference(B, H, S, d):
    """ops.wkv6 (CPU: its plain version) and wkv6_ref against the
    reference's Pallas kernel, on its sweep, to its 1e-4."""
    inputs = wkv6_inputs(0, B, H, S, d)
    jo, js = jax_wkv6(*(jnp.asarray(x) for x in inputs))
    t = _torch(*inputs)
    n = wops.wkv6.launches
    zero = torch.zeros((B, H, d, d))
    for o, s in (wkv6(*t), wkv6_ref(*t, zero)):
        assert o.shape == (B, H, S, d) and s.shape == (B, H, d, d)
        _close(o, jo)
        _close(s, js)
    assert wops.wkv6.launches == n      # CPU tensors launch nothing


@pytest.mark.parametrize("logw", [-30.0, -1e-6])
def test_wkv6_strong_decay_stability(logw):
    """Near-instant forgetting and near-perfect memory stay finite (as
    tests/test_kernels.py:92) and match the reference. The outputs reach
    ~|40| under near-perfect memory, so the float32 tolerance is relative
    there: 1e-5 of the output."""
    B, H, S, d = 1, 1, 128, 32
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, H, S, d), np.float32)
               for _ in range(3))
    lw = np.full((B, H, S, d), logw, np.float32)
    u = np.zeros((H, d), np.float32)
    jo, js = jax_wkv6(*(jnp.asarray(x) for x in (r, k, v, lw, u)))
    o, s = wkv6(*_torch(r, k, v, lw, u))
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(to_np(o), to_np(jo), atol=WKV6_TOL, rtol=1e-5)
    np.testing.assert_allclose(to_np(s), to_np(js), atol=WKV6_TOL, rtol=1e-5)


@pytest.mark.parametrize("B,H,S,d", [WKV6_SWEEP[1], WKV6_SWEEP[2]])
def test_wkv6_grad_matches_reference(B, H, S, d):
    """The gradient of ops.wkv6 (autograd of the chunked form from a zero
    state, S padded to the chunk where it is ragged) against jax.vjp of the
    reference's wkv6 (its custom_vjp through its per-token oracle), for
    cotangents on both outputs; float32 sums over S tokens, so 1e-4
    relative to each gradient's largest entry."""
    inputs = wkv6_inputs(1, B, H, S, d)
    rng = np.random.default_rng(2)
    g_o = rng.standard_normal((B, H, S, d), np.float32)
    g_s = rng.standard_normal((B, H, d, d), np.float32)
    _, vjp = jax.vjp(jax_wkv6, *(jnp.asarray(x) for x in inputs))
    want = vjp((jnp.asarray(g_o), jnp.asarray(g_s)))
    t = [x.requires_grad_() for x in _torch(*inputs)]
    got = torch.autograd.grad(wkv6(*t), t, _torch(g_o, g_s))
    for a, b in zip(got, want):
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


def test_wkv6_grad_with_only_the_output_used():
    """An unused S_final gets a zero gradient, as jax.grad through o
    alone."""
    inputs = wkv6_inputs(4, 1, 2, 65, 16)
    want = jax.grad(lambda *a: jnp.sum(jax_wkv6(*a)[0] ** 2),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(x)
                                               for x in inputs))
    t = [x.requires_grad_() for x in _torch(*inputs)]
    (wkv6(*t)[0] ** 2).sum().backward()
    for x, b in zip(t, want):
        b = to_np(b)
        np.testing.assert_allclose(to_np(x.grad), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("logw", [-30.0, -1e-6])
def test_wkv6_grad_strong_decay(logw):
    """The gradient under near-instant forgetting and near-perfect memory
    stays finite and matches the reference's, over a ragged S (padded to
    the chunk in the backward): 1e-4 relative to each gradient's largest
    entry, as above, plus 1e-7 of the largest entry of all five. The
    chunked form gets logw's gradient as a sum of terms of the whole
    gradient's size that cancel through its cumsum, so it carries their
    rounding; at logw = -30 the true logw gradient is ~1e-11 and the
    chunked form's is that residue (read: 3.8e-6 against a largest entry
    of 172)."""
    B, H, S, d = 1, 1, 100, 32
    rng = np.random.default_rng(7)
    r, k, v = (rng.standard_normal((B, H, S, d), np.float32)
               for _ in range(3))
    inputs = (r, k, v, np.full((B, H, S, d), logw, np.float32),
              0.5 * rng.standard_normal((H, d)).astype(np.float32))
    g_o = rng.standard_normal((B, H, S, d), np.float32)
    g_s = rng.standard_normal((B, H, d, d), np.float32)
    _, vjp = jax.vjp(jax_wkv6, *(jnp.asarray(x) for x in inputs))
    want = vjp((jnp.asarray(g_o), jnp.asarray(g_s)))
    t = [x.requires_grad_() for x in _torch(*inputs)]
    got = torch.autograd.grad(wkv6(*t), t, _torch(g_o, g_s))
    scale = max(np.abs(to_np(b)).max() for b in want)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-7 * scale)


@pytest.mark.parametrize("B,H,S,d", [(2, 2, 128, 32), (1, 4, 64, 64),
                                     (2, 1, 16, 16)])
def test_wkv6_chunked_matches_reference(B, H, S, d):
    """The plain chunked form from a nonzero state (prefill and decode
    carry one) against the reference's."""
    inputs = wkv6_inputs(5, B, H, S, d)
    S0 = np.random.default_rng(6).standard_normal(
        (B, H, d, d)).astype(np.float32) * 0.3
    jo, js = JL._wkv6_chunked(*(jnp.asarray(x) for x in (*inputs, S0)))
    o, s = TL._wkv6_chunked(*_torch(*inputs, S0))
    _close(o, jo)
    _close(s, js)
    # the chunked form and the per-token plain version agree
    o2, s2 = wkv6_ref(*_torch(*inputs, S0))
    _close(o, o2)
    _close(s, s2)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _split(tree):
    """A numpy tree as (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _split(v) for k, v in tree.items()}
        return ({k: j for k, (j, _) in pairs.items()},
                {k: t for k, (_, t) in pairs.items()})
    return both(tree)


def _time_mix_params(seed, D, H, hd):
    rng = np.random.default_rng(seed)
    r_lora = max(8, D // 64)
    p = {f"mu_{n}": rng.random(D) for n in "rkvgw"}
    p.update(w0=-1.5 + 0.3 * rng.standard_normal(D),
             w_lora={"a": 0.1 * rng.standard_normal((D, r_lora)),
                     "b": 0.1 * rng.standard_normal((r_lora, D))},
             u=0.5 * rng.standard_normal((H, hd)),
             ln_x=1 + 0.1 * rng.standard_normal(D),
             wo=rng.standard_normal((H, hd, D)) / np.sqrt(D))
    for n in ("wr", "wk", "wv", "wg"):
        p[n] = rng.standard_normal((D, H, hd)) / np.sqrt(D)
    return _split(_f32(p))


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_rwkv_time_mix_matches_reference(use_kernels, with_state):
    jc, tc = cfg_pair("rwkv6-7b", smoke=True)
    D, hd = jc.d_model, jc.head_dim_()
    H = D // hd
    jp, tp = _time_mix_params(7, D, H, hd)
    rng = np.random.default_rng(8)
    jx, tx = both(rng.standard_normal((2, 16, D)).astype(np.float32))
    jst = tst = None
    if with_state:
        jst, tst = _split(_f32({
            "shift": rng.standard_normal((2, 1, D)),
            "wkv": 0.3 * rng.standard_normal((2, H, hd, hd))}))
    jo, jnew = JL.rwkv_time_mix(jp, jx, jc, state=jst,
                                use_pallas=use_kernels)
    to, tnew = TL.rwkv_time_mix(tp, tx, tc, state=tst,
                                use_kernels=use_kernels)
    _close(to, jo, LAYER_TOL)
    _close(tnew["shift"], jnew["shift"], 0)
    _close(tnew["wkv"], jnew["wkv"], LAYER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix_matches_reference(with_state):
    D, Fd = 64, 128
    rng = np.random.default_rng(9)
    jp, tp = _split(_f32({"mu_k": rng.random(D), "mu_r": rng.random(D),
                          "wk": rng.standard_normal((D, Fd)) / np.sqrt(D),
                          "wv": rng.standard_normal((Fd, D)) / np.sqrt(Fd),
                          "wr": rng.standard_normal((D, D)) / np.sqrt(D)}))
    jx, tx = both(rng.standard_normal((2, 9, D)).astype(np.float32))
    js, ts = (both(rng.standard_normal((2, 1, D)).astype(np.float32))
              if with_state else (None, None))
    jo, jnew = JL.rwkv_channel_mix(jp, jx, state=js)
    to, tnew = TL.rwkv_channel_mix(tp, tx, state=ts)
    _close(to, jo, 2e-5)
    _close(tnew, jnew, 0)


# ---------------------------------------------------------------------------
# The rwkv6-7b model (smoke variant: d_model 64, 4 heads of 16, 2 layers)
# ---------------------------------------------------------------------------


@functools.cache
def _setup(f32=True):
    jc, tc = cfg_pair("rwkv6-7b", smoke=True, f32=f32)
    jparams = jax.jit(JM.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, 1)
    return jc, tc, jparams, jax_to_torch(jparams)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def test_rwkv_init_params_matches_reference_layout():
    """Same tree, shapes and dtypes (bf16 weights, float32 w0, w_lora, u
    and ln_x), the same constants, and random leaves of the same scale
    (within 10%: u has only 4 x 64 values per layer here)."""
    jc, tc = cfg_pair("rwkv6-7b", f32=False, num_layers=2, d_model=256,
                      d_ff=512, vocab_size=512)
    want = jax.tree_util.tree_flatten_with_path(
        JM.init_params(jax.random.PRNGKey(0), jc))[0]
    got = TM.init_params(torch.Generator().manual_seed(0), tc)
    assert len(want) == len(jax.tree.leaves(got))
    for path, leaf in want:
        t = got
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        a, b = to_np(leaf), to_np(t)
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        assert str(leaf.dtype) == str(t.dtype).removeprefix("torch."), name
        if a.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert abs(b.std() / a.std() - 1) < 0.1, name


@pytest.mark.parametrize("use_kernels", [True, False])
def test_rwkv_forward_matches_reference(use_kernels):
    jc, tc, jparams, tparams = _setup()
    toks = _tokens(1, 2, 16, jc.vocab_size)
    want, _, _ = JM.forward(jparams, jc, toks, remat=False,
                            use_pallas=use_kernels)
    got, aux, _ = TM.forward(tparams, tc, torch.from_numpy(toks),
                             use_kernels=use_kernels)
    assert got.shape == (2, 16, tc.padded_vocab()) and float(aux) == 0
    _close(got, want, LOGIT_TOL_F32)


def test_rwkv_prefill_and_decode_match_reference():
    """Prefill 8 tokens into zeroed caches, then decode 4; logits and the
    shift / WKV states match the reference's step by step."""
    jc, tc, jparams, tparams = _setup()
    toks = _tokens(2, 2, 12, jc.vocab_size)
    P = 8
    jcache = JM.init_caches(jc, 2, 12, tp=1, dtype=jnp.float32)
    tcache = TM.init_caches(tc, 2, 12, tp=1, dtype=torch.float32,
                            device="cpu")
    assert jax.tree.map(np.shape, jcache["layers"]) == jax.tree.map(
        lambda t: tuple(t.shape), tcache["layers"])
    jl, _, jcache = JM.forward(jparams, jc, toks[:, :P], caches=jcache,
                               remat=False)
    tl, _, tcache = TM.forward(tparams, tc, torch.from_numpy(toks[:, :P]),
                               caches=tcache)
    _close(tl, jl, LOGIT_TOL_F32)
    for t in range(P, 12):
        jl, jcache = JM.decode_step(jparams, jc, toks[:, t:t + 1], jcache)
        tl, tcache = TM.decode_step(tparams, tc,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    tcache)
        _close(tl, jl, LOGIT_TOL_F32)
    want = caches_from_numpy(jax.tree.map(np.asarray, jcache))
    assert want["index"] == tcache["index"] == 12
    for got, ref in zip(jax.tree.leaves(
            jax.tree.map(to_np, tcache["layers"])),
            jax.tree.leaves(jax.tree.map(to_np, want["layers"]))):
        _close(got, ref, WKV6_TOL)


def test_rwkv_decode_matches_forward():
    """Teacher forcing on the port alone, bf16: prefill + decode logits
    equal the full forward's (as tests/test_models.py:56-81)."""
    _, tc = cfg_pair("rwkv6-7b", smoke=True, f32=False)
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


def _loss_and_grads(params, cfg, toks, **kw):
    leaves = {k: v for k, v in _flat(params)}
    for v in leaves.values():
        v.requires_grad_()
    logits, _, _ = TM.forward(params, cfg, torch.from_numpy(toks), **kw)
    loss = logits.float().square().mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for v in leaves.values():
        v.requires_grad_(False)
    return loss.detach(), grads


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["rwkv6-7b", "lovelock-20m"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_remat_matches_no_remat(arch, use_kernels):
    """Recomputing each period in the backward changes no number: loss and
    every gradient equal those without remat, bit for bit on the CPU."""
    if arch == "rwkv6-7b":
        tc, params = _setup()[1], _setup()[3]
    else:
        _, tc = cfg_pair(arch, num_layers=2)
        params = TM.init_params(torch.Generator().manual_seed(0), tc)
    toks = _tokens(5, 2, 16, tc.vocab_size)
    l0, g0 = _loss_and_grads(params, tc, toks, remat=False,
                             use_kernels=use_kernels)
    l1, g1 = _loss_and_grads(params, tc, toks, remat=True,
                             use_kernels=use_kernels)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
