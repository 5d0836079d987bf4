"""Each dense layer function of the port against its counterpart in
`repro.models.layers`, in float32, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import both, cfg_pair, to_np  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = 2e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _attn_params(seed, cfg, *, scale=0.2):
    """Random attention params of cfg's shapes: numpy -> (jax, torch)."""
    rng = _rng(seed)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_()
    p = {"wq": rng.standard_normal((D, H, hd)) * scale,
         "wk": rng.standard_normal((D, K, hd)) * scale,
         "wv": rng.standard_normal((D, K, hd)) * scale,
         "wo": rng.standard_normal((H, hd, D)) * scale}
    if cfg.qk_norm:
        p["qn"] = rng.standard_normal(hd) * 0.1
        p["kn"] = rng.standard_normal(hd) * 0.1
    p = {k: v.astype(np.float32) for k, v in p.items()}
    pairs = {k: both(v) for k, v in p.items()}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(to_np(a), to_np(b), atol=tol, rtol=0)


def test_rms_norm():
    x = _rng(0).standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = _rng(1).standard_normal(64).astype(np.float32) * 0.1
    (jx, tx), (js, ts) = both(x), both(s)
    _close(JL.rms_norm(jx, js, 1e-5), TL.rms_norm(tx, ts, 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("start,tol", [
    (0, 1e-5),
    # XLA's and torch's float32 exp differ by one ulp on a few of the
    # frequencies; at position ~4150 that moves the float32 angle by one
    # ulp (2**-11), so the rotated values (|x| < 5) differ by up to ~2e-3
    (4150, 5 * 2.0 ** -11),
])
def test_rope_split_halves(theta, start, tol):
    x = _rng(2).standard_normal((2, 7, 4, 80)).astype(np.float32)
    pos = np.stack([np.arange(7), 40 + np.arange(7)]).astype(np.int32)
    (jx, tx), (jp, tp) = both(x), both(pos + start, "int32")
    _close(JL.rope(jx, jp, theta), TL.rope(tx, tp, theta), tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None), (False, 4)])
def test_mask_bias(causal, window):
    qp = np.array([[0, 1, 2, 5, 9]], np.int32)
    kp = np.array([[0, 2, 4, 6, 8, 9]], np.int32)
    (jq, tq), (jk, tk) = both(qp, "int32"), both(kp, "int32")
    np.testing.assert_array_equal(
        to_np(JL._mask_bias(jq, jk, causal, window)),
        to_np(TL._mask_bias(tq, tk, causal, window)))


def _qkv_inputs(seed, B, Sq, Sk, H, K, d):
    rng = _rng(seed)
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Sk, K, d)).astype(np.float32),
            rng.standard_normal((B, Sk, K, d)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 5])
def test_attn_core(window):
    q, k, v = _qkv_inputs(3, 2, 12, 12, 4, 2, 16)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    (jq, tq), (jk, tk), (jv, tv) = (both(x) for x in (q, k, v))
    jp, tp = both(pos, "int32")
    jb = JL._mask_bias(jp, jp, True, window)
    tb = TL._mask_bias(tp, tp, True, window)
    _close(JL._attn_core(jq, jk, jv, jb), TL._attn_core(tq, tk, tv, tb))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_attn_core_chunked(causal, window):
    q, k, v = _qkv_inputs(4, 2, 32, 32, 6, 2, 16)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    (jq, tq), (jk, tk), (jv, tv) = (both(x) for x in (q, k, v))
    jp, tp = both(pos, "int32")
    _close(JL._attn_core_chunked(jq, jk, jv, jp, jp, causal, window, 8),
           TL._attn_core_chunked(tq, tk, tv, tp, tp, causal, window, 8))


@pytest.mark.parametrize("arch", ["qwen3-32b", "h2o-danube-1.8b"])
def test_qkv_and_proj_out(arch):
    jc, tc = cfg_pair(arch, smoke=True)
    jp, tp = _attn_params(5, jc)
    jx, tx = both(_rng(6).standard_normal((2, 5, jc.d_model)).astype(
        np.float32))
    for a, b in zip(JL._qkv(jp, jx, jx, jc), TL._qkv(tp, tx, tx, tc)):
        _close(a, b)
    o = _rng(7).standard_normal((2, 5, jc.num_heads, jc.head_dim_()))
    jo, to = both(o.astype(np.float32))
    _close(JL._proj_out(jp, jo), TL._proj_out(tp, to))


def _cache(seed, B, W, K, hd):
    rng = _rng(seed)
    return {n: rng.standard_normal((B, W, K, hd)).astype(np.float32)
            for n in ("k", "v")}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("S,W,cache_index", [
    (6, None, None),      # no cache
    (5, 8, 0),            # prompt shorter than the ring
    (5, 8, 6),            # write wraps past the end of the ring
    (12, 8, 0),           # S >= W: the ring keeps the tail
    (13, 8, 3),
])
def test_self_attention(S, W, cache_index, use_kernels):
    jc, tc = cfg_pair("h2o-danube-1.8b", smoke=True, sliding_window=8)
    jp, tp = _attn_params(8, jc)
    jx, tx = both(_rng(9).standard_normal((2, S, jc.d_model)).astype(
        np.float32))
    jcache = tcache = None
    if W is not None:
        c = _cache(10, 2, W, jc.num_kv_heads, jc.head_dim_())
        jcache = {n: both(a)[0] for n, a in c.items()}
        tcache = {n: both(a)[1] for n, a in c.items()}
    jo, jnew = JL.self_attention(jp, jx, jc, kv_cache=jcache,
                                 cache_index=cache_index)
    to, tnew = TL.self_attention(tp, tx, tc, kv_cache=tcache,
                                 cache_index=cache_index,
                                 use_kernels=use_kernels)
    _close(jo, to)
    if W is not None:
        for n in ("k", "v"):
            _close(jnew[n], tnew[n])
            assert tnew[n] is tcache[n]          # written in place


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch,cache_index", [
    ("h2o-danube-1.8b", 3),     # ring not yet full
    ("h2o-danube-1.8b", 8),     # first wrap
    ("h2o-danube-1.8b", 13),    # wrapped ring positions
    ("qwen3-32b", 5),           # qk_norm, full cache
])
def test_decode_attention_ring(arch, cache_index, use_kernels):
    jc, tc = cfg_pair(arch, smoke=True, sliding_window=8
                      if arch == "h2o-danube-1.8b" else None)
    jp, tp = _attn_params(11, jc)
    jx, tx = both(_rng(12).standard_normal((2, 1, jc.d_model)).astype(
        np.float32))
    c = _cache(13, 2, 8, jc.num_kv_heads, jc.head_dim_())
    jcache = {n: both(a)[0] for n, a in c.items()}
    tcache = {n: both(a)[1] for n, a in c.items()}
    jo, jnew = JL.decode_attention(
        jp, jx, jc, cache=jcache,
        cache_index=both(np.int32(cache_index), "int32")[0])
    to, tnew = TL.decode_attention(tp, tx, tc, cache=tcache,
                                   cache_index=cache_index,
                                   use_kernels=use_kernels)
    _close(jo, to)
    for n in ("k", "v"):
        _close(jnew[n], tnew[n])


def test_swiglu():
    rng = _rng(14)
    p = {"w_gate": rng.standard_normal((32, 48)) * 0.2,
         "w_up": rng.standard_normal((32, 48)) * 0.2,
         "w_down": rng.standard_normal((48, 32)) * 0.2}
    pairs = {k: both(v.astype(np.float32)) for k, v in p.items()}
    jx, tx = both(rng.standard_normal((2, 5, 32)).astype(np.float32))
    _close(JL.swiglu({k: j for k, (j, _) in pairs.items()}, jx),
           TL.swiglu({k: t for k, (_, t) in pairs.items()}, tx))
