"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither jax nor the reference package, so it also runs where jax is not
installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (DECODE_SWEEP, FLASH_SWEEP, KERNEL_TOL,  # noqa: E402
                           WKV6_SWEEP, WKV6_TOL, decode_inputs,
                           flash_inputs, to_np, wkv6_inputs)
from _torch_parity import cuda_device  # noqa: E402,F401  (a fixture)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.mamba_scan import ops as mops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import (  # noqa: E402
    mamba_ssm_chunked)
from repro_torch.kernels.moe_route import ops as rops  # noqa: E402
from repro_torch.kernels.moe_route.ref import (  # noqa: E402
    route_positions_ref)
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_ref  # noqa: E402

pytestmark = pytest.mark.cuda


def _assert_held(out, gold):
    """The kernels compute in float32 whatever their inputs, so they are
    held against the plain version run in float32 on the same inputs: to
    the float32 tolerance, plus bf16's unit roundoff (2^-8) relative where
    the output is bf16."""
    rtol = 2.0 ** -8 if out.dtype == torch.bfloat16 else 0.0
    np.testing.assert_allclose(to_np(out), to_np(gold),
                               atol=KERNEL_TOL["float32"], rtol=rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,d,causal,win", FLASH_SWEEP)
def test_flash_attention_kernel_on_card(cuda_device, B, S, H, K, d, causal,
                                        win, dtype):
    q, k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
               for x in flash_inputs(0, B, S, H, K, d))
    n = fops.flash_attention.launches
    o = fops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n + 1
    assert o.dtype == q.dtype and o.shape == q.shape
    _assert_held(o, flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=win))


# bf16 takes the tensor-core kernel: every head dim at S = 300, which is not
# a multiple of its 128-row q-tile and spans three of them; H / K = 1, 4, 8;
# causal with and without a window, and non-causal with and without one
FLASH_BF16_MASKS = [(8, 8, True, None), (8, 2, True, 100),   # H, K, causal,
                    (8, 1, False, None), (8, 2, False, 100)]  # window


@pytest.mark.parametrize("H,K,causal,win", FLASH_BF16_MASKS)
@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
def test_flash_attention_bf16_every_head_dim_on_card(cuda_device, d, H, K,
                                                     causal, win):
    q, k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
               for x in flash_inputs(d, 2, 300, H, K, d))
    n = fops.flash_attention.launches
    o = fops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    _assert_held(o, flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=win))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,W,H,K,d", DECODE_SWEEP)
def test_decode_attention_kernel_on_card(cuda_device, B, W, H, K, d, dtype):
    q, k, v, bias = decode_inputs(1, B, W, H, K, d)
    q, k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
               for x in (q, k, v))
    bias = torch.from_numpy(bias).to(cuda_device)
    n = dops.decode_attention.launches
    o = dops.decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == n + 1
    assert o.dtype == q.dtype and o.shape == q.shape
    _assert_held(o, decode_attention_ref(q.float(), k.float(), v.float(),
                                         bias))


def test_decode_attention_kernel_bf16_cache_under_f32_query(cuda_device):
    q, k, v, bias = decode_inputs(2, 2, 100, 4, 2, 64)
    q = torch.from_numpy(q).to(cuda_device)
    k, v = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
            for x in (k, v))
    bias = torch.from_numpy(bias).to(cuda_device)
    o = dops.decode_attention(q, k, v, bias)
    assert o.dtype == torch.float32
    _assert_held(o, decode_attention_ref(q, k.float(), v.float(), bias))


# the edges of the one-launch design: B, W, H, K, d and the mask. "split s"
# masks every slot of split s (as `split_plan` cuts W on this card), which
# must add nothing in the cluster's merge; the W are not multiples of a
# tile (128 slots at d <= 80 in bf16, fewer for wider rows) or span one
# tile; G = H / K is 1, 2, 8 and 16
DECODE_EDGES = [(1, 1024, 16, 1, 64, "split 0"),
                (1, 4096, 4, 1, 112, "split 1"),
                (2, 300, 4, 4, 80, "random"),
                (1, 777, 32, 2, 128, "split 0"),
                (2, 33, 16, 1, 32, "random"),
                (3, 1000, 8, 4, 80, "random")]
DTYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "bfloat16")]   # (q, cache)


@pytest.mark.parametrize("qt,ct", DTYPE_PAIRS)
@pytest.mark.parametrize("B,W,H,K,d,mask", DECODE_EDGES)
def test_decode_attention_edges_on_card(cuda_device, B, W, H, K, d, mask,
                                        qt, ct):
    q, k, v, bias = decode_inputs(3, B, W, H, K, d)
    q = torch.from_numpy(q).to(cuda_device, getattr(torch, qt))
    k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, ct))
            for x in (k, v))
    bias = torch.from_numpy(bias).to(cuda_device)
    if mask != "random":
        n_sm = torch.cuda.get_device_properties(
            cuda_device).multi_processor_count
        per, nsplit = dops.split_plan(W, B, K, n_sm)
        s = int(mask.split()[1])
        assert s < nsplit
        span = per * dops.SLOTS_PER_CHUNK
        bias[:, s * span:(s + 1) * span] = -1e30
    n = dops.decode_attention.launches
    o = dops.decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == n + 1
    assert o.dtype == q.dtype and o.shape == q.shape
    assert torch.isfinite(o).all()
    _assert_held(o, decode_attention_ref(q.float(), k.float(), v.float(),
                                         bias))


def test_decode_attention_is_deterministic_on_card(cuda_device):
    """The cluster merges its splits in split order, not in order of
    arrival: the same inputs give the same bits."""
    q, k, v, bias = (torch.from_numpy(x).to(cuda_device)
                     for x in decode_inputs(4, 4, 4096, 32, 8, 80))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    first = dops.decode_attention(q, k, v, bias)
    for _ in range(5):
        assert torch.equal(dops.decode_attention(q, k, v, bias), first)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 16, 2, 48), device=cuda_device)   # d=48: not built
    kv = torch.zeros((1, 16, 1, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fops.flash_attention(q, kv, kv)
    q = torch.zeros((1, 16, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fops.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(TypeError, match="dtype"):
        fops.flash_attention(q.half(), q.half(), q.half())


def _wkv6_on_card(dev, *inputs):
    return [torch.from_numpy(x).to(dev) for x in inputs]


@pytest.mark.parametrize("B,H,S,d", WKV6_SWEEP)
def test_wkv6_kernel_on_card(cuda_device, B, H, S, d):
    """float32 in and out: held against wkv6_ref on the card to the
    reference's 1e-4."""
    r, k, v, lw, u = _wkv6_on_card(cuda_device, *wkv6_inputs(0, B, H, S, d))
    n = wops.wkv6.launches
    o, s = wops.wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert wops.wkv6.launches == n + 1
    ro, rs = wkv6_ref(r, k, v, lw, u, torch.zeros_like(s))
    np.testing.assert_allclose(to_np(o), to_np(ro), atol=WKV6_TOL, rtol=0)
    np.testing.assert_allclose(to_np(s), to_np(rs), atol=WKV6_TOL, rtol=0)


# the kernel stages chunks of 16 tokens (32 at d = 16): S = 1, one below and
# one above a multiple of the chunk, and d = 16, 32, 64 (B, H, S, d)
WKV6_EDGES = [(1, 2, 1, 64), (2, 2, 31, 64), (1, 3, 33, 32), (1, 2, 95, 16),
              (2, 1, 97, 64), (1, 2, 64, 16)]


@pytest.mark.parametrize("B,H,S,d", WKV6_EDGES)
def test_wkv6_kernel_edges_on_card(cuda_device, B, H, S, d):
    r, k, v, lw, u = _wkv6_on_card(cuda_device, *wkv6_inputs(5, B, H, S, d))
    n = wops.wkv6.launches
    o, s = wops.wkv6(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert wops.wkv6.launches == n + 1
    ro, rs = wkv6_ref(r, k, v, lw, u, torch.zeros_like(s))
    np.testing.assert_allclose(to_np(o), to_np(ro), atol=WKV6_TOL, rtol=0)
    np.testing.assert_allclose(to_np(s), to_np(rs), atol=WKV6_TOL, rtol=0)


@pytest.mark.parametrize("logw", [-30.0, -1e-6])
def test_wkv6_kernel_strong_decay_on_card(cuda_device, logw):
    g = torch.Generator(cuda_device).manual_seed(0)
    r, k, v = (torch.randn((1, 1, 128, 32), generator=g, device=cuda_device)
               for _ in range(3))
    lw = torch.full_like(r, logw)
    u = torch.zeros((1, 32), device=cuda_device)
    o, s = wops.wkv6(r, k, v, lw, u)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    ro, _ = wkv6_ref(r, k, v, lw, u, torch.zeros_like(s))
    # outputs reach ~|40| under near-perfect memory: 1e-5 relative there
    np.testing.assert_allclose(to_np(o), to_np(ro), atol=WKV6_TOL, rtol=1e-5)


def test_wkv6_grad_on_card(cuda_device):
    """The gradient through the kernel's autograd.Function (autograd of
    the chunked form, S = 100 padded to 128) against autograd of the
    per-token wkv6_ref, an independent form: 1e-4 relative to each
    gradient's largest entry."""
    inputs = _wkv6_on_card(cuda_device, *wkv6_inputs(1, 1, 4, 100, 64))
    g_o = torch.randn_like(inputs[0])
    t = [x.clone().requires_grad_() for x in inputs]
    o, s = wops.wkv6(*t)
    got = torch.autograd.grad((o * g_o).sum() + s.square().sum(), t)
    t2 = [x.clone().requires_grad_() for x in inputs]
    ro, rs = wkv6_ref(*t2, torch.zeros_like(s))
    want = torch.autograd.grad((ro * g_o).sum() + rs.square().sum(), t2)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0,
                                   atol=1e-4 * b.abs().max().item())


def test_flash_attention_grad_on_card(cuda_device):
    q, k, v = (torch.from_numpy(x).to(cuda_device).requires_grad_()
               for x in flash_inputs(2, 2, 200, 4, 1, 80))
    g = torch.randn_like(q)
    n = fops.flash_attention.launches
    got = torch.autograd.grad(fops.flash_attention(q, k, v, window=96),
                              (q, k, v), g)
    assert fops.flash_attention.launches == n + 1
    want = torch.autograd.grad(flash_attention_ref(q, k, v, window=96),
                               (q, k, v), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0,
                                   atol=1e-4 * b.abs().max().item())


def test_wkv6_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 2, 8, 48), device=cuda_device)   # d=48: not built
    with pytest.raises(ValueError, match="head dim"):
        wops.wkv6(x, x, x, x, torch.zeros((2, 48), device=cuda_device))
    x = torch.zeros((1, 2, 8, 64), device=cuda_device)
    u = torch.zeros((2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        wops.wkv6(x.transpose(1, 2), x, x, x, u)
    with pytest.raises(TypeError, match="float32"):
        wops.wkv6(x.bfloat16(), x, x, x, u)


SSM_TOL = 1e-5    # float32; the plain form's doubling rounds in its own order


def _ssm_on_card(dev, seed, B, S, I, N, dtype=torch.float32):
    """dt in (0, 0.5), A = -(1..N) per channel, Bm, Cm, xin and a nonzero
    h0 normal, on the card (the inputs of tests/test_torch_mamba.py made by
    torch); dt, Bm, Cm and xin in `dtype`, A and h0 float32."""
    g = torch.Generator(dev).manual_seed(seed)
    dt = torch.rand((B, S, I), generator=g, device=dev) * 0.5
    A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(
        I, N).contiguous()
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev)
              for _ in range(2))
    xin = torch.randn((B, S, I), generator=g, device=dev)
    h0 = torch.randn((B, I, N), generator=g, device=dev)
    return (dt.to(dtype), A, Bm.to(dtype), Cm.to(dtype), xin.to(dtype), h0)


def _ssm_plain(dt, A, Bm, Cm, xin, h0):
    """The plain form on float32 copies of dt, Bm, Cm and xin."""
    return mamba_ssm_chunked(dt.float(), A, Bm.float(), Cm.float(),
                             xin.float(), h0)


# (B, S, I, N): one token, a ragged chunk of 7, 300 (not a multiple of the
# kernel's 32-token chunks), two plain chunks of 256, and 16 of them; I not
# a multiple of the kernel's 32 channels a block (40, 100, 72); N = 16,
# the kernel's (I even: the kernel reads bf16 channels in pairs)
MAMBA_SWEEP = [(2, 1, 64, 16), (2, 7, 40, 16), (1, 300, 100, 16),
               (2, 512, 96, 16), (1, 4096, 64, 16), (3, 33, 32, 16),
               (1, 65, 72, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,I,N", MAMBA_SWEEP)
def test_mamba_scan_kernel_on_card(cuda_device, B, S, I, N, dtype):
    """From a nonzero h0, dt, Bm, Cm and xin in float32 or bf16: y and
    h_final held against the plain form on their float32 copies, on the
    card, to 1e-5; one launch a call."""
    inputs = _ssm_on_card(cuda_device, S + I, B, S, I, N,
                          getattr(torch, dtype))
    n = mops.mamba_scan.launches
    y, h = mops.mamba_scan(*inputs)
    torch.cuda.synchronize()
    assert mops.mamba_scan.launches == n + 1
    assert y.dtype == h.dtype == torch.float32
    ry, rh = _ssm_plain(*inputs)
    np.testing.assert_allclose(to_np(y), to_np(ry), atol=SSM_TOL, rtol=0)
    np.testing.assert_allclose(to_np(h), to_np(rh), atol=SSM_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_kernel_at_jamba_shape_on_card(cuda_device, dtype):
    """jamba-v0.1-52b's prefill scan, (B, S, I, N) = (4, 4096, 8192, 16),
    in float32 and in the serve path's bf16, against the plain form to
    1e-5."""
    inputs = _ssm_on_card(cuda_device, 7, 4, 4096, 8192, 16,
                          getattr(torch, dtype))
    y, h = mops.mamba_scan(*inputs)
    torch.cuda.synchronize()
    ry, rh = _ssm_plain(*inputs)
    assert (y - ry).abs().max().item() <= SSM_TOL
    assert (h - rh).abs().max().item() <= SSM_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_grad_on_card(cuda_device, dtype):
    """The gradient through the kernel's autograd.Function (autograd of
    the plain form, recomputed) against plain autograd, in each input's
    dtype: 1e-5 relative to each gradient's largest entry."""
    inputs = _ssm_on_card(cuda_device, 3, 2, 300, 40, 16,
                          getattr(torch, dtype))
    g_y = torch.randn(inputs[4].shape, device=cuda_device)
    t = [x.clone().requires_grad_() for x in inputs]
    y, h = mops.mamba_scan(*t)
    got = torch.autograd.grad((y * g_y).sum() + h.square().sum(), t)
    t2 = [x.clone().requires_grad_() for x in inputs]
    ry, rh = _ssm_plain(*t2)
    want = torch.autograd.grad((ry * g_y).sum() + rh.square().sum(), t2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(to_np(a.float()), to_np(b.float()),
                                   rtol=0,
                                   atol=SSM_TOL * b.abs().max().item())


def test_mamba_scan_rejects_what_it_does_not_take(cuda_device):
    dt, A, Bm, Cm, xin, h0 = _ssm_on_card(cuda_device, 0, 1, 8, 32, 16)
    with pytest.raises(ValueError, match="d_state"):
        mops.mamba_scan(dt, *(t[..., :12].contiguous() for t in (A, Bm, Cm)),
                        xin, h0[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        mops.mamba_scan(dt, A, Bm, Cm,
                        xin.transpose(1, 2).contiguous().transpose(1, 2),
                        h0)
    with pytest.raises(TypeError, match="float32"):
        mops.mamba_scan(dt, A.bfloat16(), Bm, Cm, xin, h0)
    with pytest.raises(ValueError, match="even"):          # I = 31
        odd = [t[..., :31].bfloat16().contiguous() for t in (dt, xin)]
        mops.mamba_scan(odd[0], A[:31], Bm.bfloat16(), Cm.bfloat16(),
                        odd[1], h0[:, :31].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        x = torch.zeros((1, 601, 32), device=cuda_device)
        mops.mamba_scan(x, A, Bm[:, :1].expand(1, 601, 16).contiguous(),
                        Bm[:, :1].expand(1, 601, 16).contiguous(), x, h0)


def _route_ids(dev, seed, N, K, E, skew):
    """(N, K) int64 top-k ids of random scores on the card, with expert 0
    first for a `skew` share of the tokens (it then overflows its 1.25 K N
    / E slots)."""
    g = torch.Generator(dev).manual_seed(seed)
    scores = torch.rand((N, E), generator=g, device=dev)
    scores[:, 0] += (torch.rand(N, generator=g, device=dev) < skew).float()
    return torch.topk(scores, K, dim=-1)[1]


# (N, K, E, skew): nemotron-3-nano-30b-a3b's prefill (2 x 8192 tokens,
# top-6 of 128) with a skewed router, jamba-v0.1-52b's (4 x 4096, top-2 of
# 16), a decode step of each (one block, one launch), kimi-k2's E 384 with
# K 8, and ragged N (one token; 33, 1000: not whole tiles of 1024)
ROUTE_CASES = [(16384, 6, 128, 0.3), (16384, 2, 16, 0.0), (2, 6, 128, 0.0),
               (4, 2, 16, 0.0), (4096, 8, 384, 0.2), (1, 6, 128, 0.0),
               (33, 2, 16, 0.5), (1000, 8, 384, 0.0)]


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("N,K,E,skew", ROUTE_CASES)
def test_moe_route_kernel_on_card(cuda_device, N, K, E, skew, with_counts):
    """Positions, and counts where asked, equal the plain form's bit for
    bit (torch.equal), twice; one launch a call."""
    ids = _route_ids(cuda_device, N + E, N, K, E, skew)
    want_pos, want_counts = route_positions_ref(ids, E, with_counts)
    outs = []
    for _ in range(2):
        n = rops.route_positions.launches
        outs.append(rops.route_positions(ids, E, with_counts))
        torch.cuda.synchronize()
        assert rops.route_positions.launches == n + 1
    for pos, counts in outs:
        assert pos.dtype == torch.int64 and pos.shape == (N, K)
        assert torch.equal(pos, want_pos)
        if with_counts:
            assert torch.equal(counts, want_counts)
        else:
            assert counts is None
    if skew:
        assert int(want_pos.max()) >= int(1.25 * K * N / E)   # overflow


def test_moe_route_with_offsets_on_card(cuda_device):
    """`_moe_route` on a rank's rows (`offsets` of its counts, as
    `_moe_sharded` gives them) on the card equals the CPU's: ids,
    positions and the kept gates exactly, overflow included, the gates'
    values to 1e-5 (the router's float32 product rounds in another
    order)."""
    import dataclasses
    from repro_torch.models import layers as L
    cfg = _cfg("jamba-v0.1-52b")
    moe = dataclasses.replace(cfg.moe, dispatch="scatter")
    rng = np.random.default_rng(5)
    D, E = cfg.d_model, moe.num_experts
    router = rng.standard_normal((D, E)).astype(np.float32) * 0.3
    router[:, 0] += 0.05
    x = rng.standard_normal((64, D)).astype(np.float32) + 1.0

    def offsets(counts):     # the choices of 3 earlier ranks like this one
        return 3 * counts.sum(0) + torch.cumsum(counts, 0) - counts
    routes = [L._moe_route({"router": torch.from_numpy(router).to(dev)},
                           torch.from_numpy(x).to(dev), moe,
                           n_tokens=4 * 64, offsets=offsets)
              for dev in ("cpu", cuda_device)]
    assert (routes[0][2] >= routes[0][3]).any()           # some overflow
    for a, b in zip(routes[1][1:3], routes[0][1:3]):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    gates, want = (to_np(r[0]) for r in routes)
    np.testing.assert_array_equal(gates > 0, want > 0)
    np.testing.assert_allclose(gates, want, atol=1e-5, rtol=0)


def test_moe_route_rejects_what_it_does_not_take(cuda_device):
    ids = _route_ids(cuda_device, 0, 64, 2, 16, 0.0)
    with pytest.raises(ValueError, match="not cuda"):      # a CPU tensor
        rops._launch_kernel(ids.cpu(), 16, False)          # at the kernel
    with pytest.raises(TypeError, match="int64"):
        rops.route_positions(ids.int(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        rops.route_positions(ids.t().contiguous().t(), 16)
    with pytest.raises(ValueError, match="experts"):
        rops.route_positions(ids, 1025)


# ---------------------------------------------------------------------------
# MoE, Mamba, the hybrid model and the checkpointer: the same code on the
# card and on the CPU (float32; TF32 is off for matmuls by default)
# ---------------------------------------------------------------------------


def _cfg(arch, dtype="float32", **replace):
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    return dataclasses.replace(smoke_variant(get_config(arch)),
                               param_dtype=dtype, compute_dtype=dtype,
                               **replace)


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_ffn_on_card(cuda_device, dispatch):
    """jamba's smoke MoE over 64 tokens with its router pulled toward one
    expert (capacity overflows): the card's routes equal the CPU's, and
    its outputs agree to 1e-5."""
    import dataclasses
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = _cfg("jamba-v0.1-52b")
    moe = dataclasses.replace(cfg.moe, dispatch=dispatch)
    p = M.init_params(torch.Generator().manual_seed(0), cfg)["layers"][1]
    p = {k: v[0] for k, v in p["moe"].items()}
    p["router"][:, 0] += 0.05            # x's common offset favours it
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32) + 1.0)
    want, want_aux = L.moe_ffn(p, x, moe)
    got, aux = L.moe_ffn(_on(p, cuda_device), x.to(cuda_device), moe)
    r_cpu = L._moe_route(p, x.reshape(64, -1), moe)
    r_gpu = L._moe_route(_on(p, cuda_device), x.reshape(64, -1).to(
        cuda_device), moe)
    assert (r_cpu[2] >= r_cpu[3]).any()           # some overflow
    for a, b in zip(r_gpu[1:3], r_cpu[1:3]):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=0)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


@pytest.mark.parametrize("S", [1, 300, 512])
def test_mamba_on_card(cuda_device, S):
    """jamba's smoke Mamba block from a nonzero state, S tokens: output and
    new state on the card against the CPU's to 1e-5."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = _cfg("jamba-v0.1-52b")
    p = {k: v[0] for k, v in M.init_params(
        torch.Generator().manual_seed(1), cfg)["layers"][0]["mamba"].items()}
    rng = np.random.default_rng(S)
    I = 2 * cfg.d_model
    x = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model)).astype(
        np.float32))
    st = {"conv": torch.from_numpy(rng.standard_normal((2, 3, I)).astype(
              np.float32)),
          "ssm": torch.from_numpy(rng.standard_normal((2, I, 16)).astype(
              np.float32))}
    want, want_st = L.mamba(p, x, cfg, state=st)
    got, got_st = L.mamba(_on(p, cuda_device), x.to(cuda_device), cfg,
                          state=_on(st, cuda_device))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-5, rtol=0)
    for n in ("conv", "ssm"):
        np.testing.assert_allclose(to_np(got_st[n]), to_np(want_st[n]),
                                   atol=1e-5, rtol=0)


def test_hybrid_model_on_card(cuda_device):
    """jamba smoke in float32 (heads of 32, a width the kernels are built
    for) through the kernels on the card: prefill of 10 tokens and 4
    decode steps, logits against the CPU's plain path to 1e-4, and one
    flash plus four decode launches, and a scan launch a Mamba layer and
    a route launch a MoE layer in the prefill and in each step."""
    from repro_torch.models import model as M
    cfg = _cfg("jamba-v0.1-52b", head_dim=32)
    specs = M.block_specs(cfg)
    n_mamba = (sum(sp["kind"] == "mamba" for sp in specs)
               * (cfg.num_layers // len(specs)))
    n_moe = (sum(sp["ffn"] == "moe" for sp in specs)
             * (cfg.num_layers // len(specs)))
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 14)))
    out = {}
    for dev in ("cpu", cuda_device):
        pp = _on(params, dev)
        caches = M.init_caches(cfg, 2, 14, dtype=torch.float32, device=dev)
        fl, dl = fops.flash_attention.launches, dops.decode_attention.launches
        ml, rl = mops.mamba_scan.launches, rops.route_positions.launches
        lg, _, caches = M.forward(pp, cfg, toks[:, :10].to(dev),
                                  caches=caches)
        steps = [lg[:, -1]]
        for t in range(10, 14):
            lg, caches = M.decode_step(pp, cfg, toks[:, t:t + 1].to(dev),
                                       caches)
            steps.append(lg[:, 0])
        out[str(dev)] = torch.stack(steps, 1)
        launched = (fops.flash_attention.launches - fl,
                    dops.decode_attention.launches - dl,
                    mops.mamba_scan.launches - ml,
                    rops.route_positions.launches - rl)
        assert launched == ((0, 0, 0, 0) if dev == "cpu" else
                            (1, 4, 5 * n_mamba, 5 * n_moe))
    np.testing.assert_allclose(to_np(out[str(cuda_device)]),
                               to_np(out["cpu"]), atol=1e-4, rtol=0)


def test_checkpoint_roundtrip_from_card(cuda_device, tmp_path):
    """A TrainState on the card (bf16 params, float32 and int8 moments)
    saved in small chunks and restored onto the card and onto the CPU:
    every leaf equal bit for bit, in flight never more than `buffers`
    chunks."""
    import json
    from repro_torch.core.streaming_checkpoint import (
        StreamingCheckpointer, _leaf_paths)
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.tree import tree_map
    cfg = _cfg("qwen3-32b", "bfloat16")
    params = M.init_params(torch.Generator(cuda_device).manual_seed(0), cfg)

    def raw(t):
        if isinstance(t, int):
            return t
        return t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy() \
            .tobytes()
    for sd in ("float32", "int8"):
        state = adamw_init(params, OptimizerConfig(state_dtype=sd))
        state = state._replace(step=3, m=tree_map(
            lambda t: t + 0.5 if t.is_floating_point() else t + 1, state.m))
        ck = StreamingCheckpointer(tmp_path / sd, chunk_bytes=4096,
                                   buffers=2)
        d = ck.save(3, state)
        chunks = [c["nbytes"] for m in json.loads(
            (d / "manifest.json").read_text())["leaves"].values()
            for c in m["chunks"]]
        assert ck.metrics.peak_buffer_bytes <= 2 * max(chunks)
        for dev in (cuda_device, torch.device("cpu")):
            like = type(state)(0, *(None if t is None else tree_map(
                lambda x: torch.zeros_like(x, device=dev), t)
                for t in state[1:]))
            rest = ck.restore(like)
            for (p, a), (_, b) in zip(_leaf_paths(state),
                                      _leaf_paths(rest)):
                if isinstance(b, torch.Tensor):
                    assert b.device.type == dev.type, p
                assert raw(a) == raw(b), p


# the cross-attention families' attention shapes: whisper's encoder is
# non-causal over 1500 frames (11 full 128-row q-tiles and 92 rows), G = 1,
# d = 64; llama-3.2-vision's self-attention has G = 8, d = 128 (here at
# ragged S, causal and not)
FLASH_XATTN = [(2, 1500, 4, 4, 64, False, None),
               (1, 1100, 16, 2, 128, True, None),
               (1, 333, 16, 2, 128, False, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,d,causal,win", FLASH_XATTN)
def test_flash_attention_xattn_shapes_on_card(cuda_device, B, S, H, K, d,
                                              causal, win, dtype):
    q, k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
               for x in flash_inputs(5, B, S, H, K, d))
    n = fops.flash_attention.launches
    o = fops.flash_attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fops.flash_attention.launches == n + 1
    _assert_held(o, flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=win))


# whisper's decode (G = 1, d = 64, 256 slots) and the VLM's (G = 8,
# d = 128, a 4,128-slot cache), for every (q, cache) dtype pair
@pytest.mark.parametrize("qt,ct", DTYPE_PAIRS)
@pytest.mark.parametrize("B,W,H,K,d", [(4, 256, 20, 20, 64),
                                       (2, 1000, 8, 8, 64),
                                       (1, 4128, 64, 8, 128)])
def test_decode_attention_xattn_shapes_on_card(cuda_device, B, W, H, K, d,
                                               qt, ct):
    q, k, v, bias = decode_inputs(6, B, W, H, K, d)
    q = torch.from_numpy(q).to(cuda_device, getattr(torch, qt))
    k, v = (torch.from_numpy(x).to(cuda_device, getattr(torch, ct))
            for x in (k, v))
    bias = torch.from_numpy(bias).to(cuda_device)
    n = dops.decode_attention.launches
    o = dops.decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert dops.decode_attention.launches == n + 1
    assert o.dtype == q.dtype
    _assert_held(o, decode_attention_ref(q.float(), k.float(), v.float(),
                                         bias))


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_xattn_model_on_card(cuda_device, arch):
    """Both cross-attention smoke families in float32 (heads of 32, a width
    the kernels are built for), random extras and (VLM) the gate at 1: the
    card's kernel path against the CPU's plain path, prefill of 10 tokens
    and 4 decode steps, logits to 1e-4; the launches: whisper's encoder
    and decoder layers flash once each, the VLM's self-attention layers;
    one decode launch per self-attention layer a step."""
    from repro_torch.models import model as M
    cfg = _cfg(arch, head_dim=32)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    for i, spec in enumerate(M.block_specs(cfg)):
        if spec["kind"] == "xattn":
            params["layers"][i]["attn"]["gate"].fill_(1.0)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 14)))
    key, T = (("audio_frames", cfg.num_audio_frames) if cfg.encoder_layers
              else ("image_embeds", cfg.num_image_tokens))
    src = torch.from_numpy(rng.standard_normal((2, T, cfg.d_model),
                                               np.float32))
    n_self = sum(s["kind"] == "attn" for s in M.block_specs(cfg)) * (
        cfg.num_layers // M.period_of(cfg))
    out = {}
    for dev, use_kernels in (("cpu", False), (cuda_device, True)):
        pp = _on(params, dev)
        caches = M.init_caches(cfg, 2, 14, dtype=torch.float32, device=dev)
        fl, dl = fops.flash_attention.launches, dops.decode_attention.launches
        ml, rl = mops.mamba_scan.launches, rops.route_positions.launches
        lg, _, caches = M.forward(pp, cfg, toks[:, :10].to(dev),
                                  extra={key: src.to(dev)}, caches=caches,
                                  use_kernels=use_kernels)
        steps = [lg[:, -1]]
        for t in range(10, 14):
            lg, caches = M.decode_step(pp, cfg, toks[:, t:t + 1].to(dev),
                                       caches, use_kernels=use_kernels)
            steps.append(lg[:, 0])
        out[str(dev)] = torch.stack(steps, 1)
        launched = (fops.flash_attention.launches - fl,
                    dops.decode_attention.launches - dl)
        want = (n_self + cfg.encoder_layers, 4 * n_self) if use_kernels \
            else (0, 0)
        assert launched == want
    np.testing.assert_allclose(to_np(out[str(cuda_device)]),
                               to_np(out["cpu"]), atol=1e-4, rtol=0)


def test_world1_nccl_gspmd_step_on_card(cuda_device, tmp_path):
    """The sharded train step on a (1, 1) mesh of a world-1 NCCL group
    against the meshless step, on the card: h2o-danube-1.8b smoke (two
    layers, head dim 32, the 32-token window) in float32, 3 steps of 4 x
    64 tokens from the same params and batches. Losses within 1e-5
    relative, params after them within 1e-6 of the largest |p|, and the
    flash kernel launched as often on both (the mesh hands it each rank's
    shard, never the plain path)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding.rules import (ShardingRules, gather, place,
                                            state_specs)
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    cfg = _cfg("h2o-danube-1.8b", head_dim=32)
    params = M.init_params(torch.Generator(cuda_device).manual_seed(0), cfg)
    oc = OptimizerConfig(lr=1e-3, warmup=2, total_steps=10)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 65),
                                             dtype=np.int32)).to(cuda_device)
        batches.append({"tokens": toks[:, :-1].contiguous(),
                        "labels": toks[:, 1:].contiguous()})
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1)
        out = {}
        for meshed in (True, False):
            state = adamw_init(tree_map(torch.clone, params), oc)
            rules = None
            if meshed:
                rules = ShardingRules(mesh)
                state = place(state, state_specs(state, mesh), mesh)
            step = make_train_step(cfg, oc, rules)
            n0 = fops.flash_attention.launches
            losses = []
            for b in batches:
                state, m = step(state, b)
                losses.append(float(m["loss"]))
            out[meshed] = (losses, fops.flash_attention.launches - n0,
                           tree_leaves(gather(state.params)))
    finally:
        dist.destroy_process_group()
    (lm, nm, pm), (lp, np_, pp) = out[True], out[False]
    np.testing.assert_allclose(lm, lp, rtol=1e-5)
    assert nm == np_ == cfg.num_layers * 2 * 3
    top = max(float(p.abs().max()) for p in pp)
    assert max(float((a - b).abs().max()) for a, b in zip(pm, pp)) \
        <= 1e-6 * top


# ---------------------------------------------------------------------------
# the water-fill solver on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,max_holds", [(1, 3), (257, 0), (4096, 7)])
def test_waterfill_fold_on_card(cuda_device, R, max_holds):
    """The capacity fold (`index_add_` of -m a hold on the card's atomics)
    is bitwise the same fold on the CPU, nan, -0.0 and entries driven
    below 0 included, and writes in place."""
    from repro_torch.sim.alloc import subtract_holds_
    rng = np.random.default_rng(R)
    rem = rng.uniform(0.0, 2.0, size=R)
    rem[: min(R, 2)] = [np.nan, -0.0][: min(R, 2)]
    idx = rng.integers(0, R, size=R * max_holds + 1)
    held = rng.random(idx.size) < 0.8
    m = torch.tensor(0.3, dtype=torch.float64)
    gold = subtract_holds_(torch.from_numpy(rem.copy()),
                           torch.from_numpy(idx), torch.from_numpy(held), m)
    t = torch.from_numpy(rem).to(cuda_device)
    out = subtract_holds_(t, torch.from_numpy(idx).to(cuda_device),
                          torch.from_numpy(held).to(cuda_device),
                          m.to(cuda_device))
    torch.cuda.synchronize()
    assert out is t
    assert out.cpu().numpy().tobytes() == gold.numpy().tobytes()


@pytest.mark.parametrize("nf", [1, 192, 3000])
def test_water_fill_on_card_bitwise(cuda_device, nf):
    """vector_water_fill_torch on the card is bitwise the port's numpy
    copy of the reference's allocator (integer capacities: ties)."""
    from repro_torch.sim.alloc import (vector_water_fill,
                                       vector_water_fill_torch)
    rng = np.random.default_rng(nf)
    nres = max(nf // 4, 1)
    counts = rng.integers(1, 5, size=nf)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    indices = rng.integers(0, nres, size=int(counts.sum())).astype(np.int64)
    cap = rng.integers(0, 9, size=nres).astype(np.float64)
    want = vector_water_fill(indptr, indices, cap.copy())
    got = vector_water_fill_torch(indptr, indices, cap.copy(),
                                  device=cuda_device)
    assert got.tobytes() == want.tobytes()
