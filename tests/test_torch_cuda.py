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
                           decode_inputs, flash_inputs, to_np)
from _torch_parity import cuda_device  # noqa: E402,F401  (a fixture)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)

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
