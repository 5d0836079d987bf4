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
