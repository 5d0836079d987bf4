"""The port's attention kernels against the reference's, and what the
three kernel wrappers share.

On the CPU the port's wrappers run their plain versions; both are held
against `repro.kernels.*.ops` (the Pallas kernels in interpret mode) on the
reference's sweeps (tests/test_kernels.py:19-25 and :60-61). The WKV6
kernel's parity tests are in tests/test_torch_rwkv.py. The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda.py.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (DECODE_SWEEP, FLASH_SWEEP, KERNEL_TOL, both,  # noqa: E402
                           decode_inputs, flash_inputs, to_np)
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jax_decode_attention)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jax_flash_attention,
    flash_attention_ref as jax_flash_attention_ref)
from repro_torch.kernels import _build, _launch  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,d,causal,win", FLASH_SWEEP)
def test_flash_attention_matches_reference(B, S, H, K, d, causal, win,
                                           dtype):
    (jq, tq), (jk, tk), (jv, tv) = (
        both(x, dtype) for x in flash_inputs(0, B, S, H, K, d))
    want = to_np(jax_flash_attention(jq, jk, jv, causal=causal, window=win))
    for fn in (flash_attention, flash_attention_ref):
        got = fn(tq, tk, tv, causal=causal, window=win)
        assert got.dtype == tq.dtype and got.shape == tq.shape
        np.testing.assert_allclose(to_np(got), want, atol=KERNEL_TOL[dtype])


@pytest.mark.parametrize("B,S,HK,d", [(1, 64, (4, 2), 32),
                                      (2, 100, (2, 2), 64),
                                      (3, 192, (8, 1), 32)])
def test_flash_attention_causality(B, S, HK, d):
    """Matches the reference oracle, and position t ignores keys > t."""
    H, K = HK
    q, k, v = flash_inputs(B * S + d, B, S, H, K, d)
    want = to_np(jax_flash_attention_ref(*(both(x)[0] for x in (q, k, v)),
                                         causal=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(to_np(o), want, atol=3e-5)
    t = S // 2
    k2, v2 = tk.clone(), tv.clone()
    k2[:, t + 1:] = 0.0
    v2[:, t + 1:] = 9.9
    o2 = flash_attention(tq, k2, v2, causal=True)
    np.testing.assert_allclose(to_np(o[:, :t + 1]), to_np(o2[:, :t + 1]),
                               atol=3e-5)


@pytest.mark.parametrize("case", [FLASH_SWEEP[0], FLASH_SWEEP[2],
                                  FLASH_SWEEP[3]])
def test_flash_attention_grad_matches_reference(case):
    """The gradient of flash_attention (autograd of its plain version, as
    the reference's custom_vjp) against jax.vjp of the reference's,
    float32; 1e-4 relative to each gradient's largest entry (sums over S
    keys in another order)."""
    B, S, H, K, d, causal, win = case
    q, k, v = flash_inputs(7, B, S, H, K, d)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_flash_attention(*a, causal=causal,
                                                    window=win),
                     *(both(x)[0] for x in (q, k, v)))
    want = vjp(both(g)[0])
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention(*t, causal=causal, window=win)
    got = torch.autograd.grad(o, t, torch.from_numpy(g))
    for a, b in zip(got, want):
        b = to_np(b)
        np.testing.assert_allclose(to_np(a), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,W,H,K,d", DECODE_SWEEP)
def test_decode_attention_matches_reference(B, W, H, K, d, dtype):
    q, k, v, bias = decode_inputs(1, B, W, H, K, d)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, k, v))
    jb, tb = both(bias)
    want = to_np(jax_decode_attention(jq, jk, jv, jb))
    got = decode_attention(tq, tk, tv, tb)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(to_np(got), want, atol=KERNEL_TOL[dtype])
    np.testing.assert_allclose(to_np(decode_attention_ref(tq, tk, tv, tb)),
                               want, atol=KERNEL_TOL[dtype])


def test_decode_attention_bf16_cache_under_f32_query():
    """A bf16 cache under a float32 model: output in q's dtype."""
    q, k, v, bias = decode_inputs(2, 2, 100, 4, 2, 64)
    jq, tq = both(q)
    (jk, tk), (jv, tv) = both(k, "bfloat16"), both(v, "bfloat16")
    jb, tb = both(bias)
    want = to_np(jax_decode_attention(jq, jk, jv, jb))
    got = decode_attention(tq, tk, tv, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, atol=KERNEL_TOL["bfloat16"])


def test_cpu_path_counts_no_launches():
    q, k, v = (torch.from_numpy(x) for x in flash_inputs(3, 1, 16, 2, 1,
                                                          32))
    before = (flash_attention.launches, decode_attention.launches,
              wops.wkv6.launches)
    flash_attention(q, k, v, causal=True)
    decode_attention(q[:, :1], k, v, torch.zeros(1, 16))
    r = q.transpose(1, 2).contiguous()
    wops.wkv6(r, r, r, -r.abs(), torch.zeros(2, 32))
    assert (flash_attention.launches, decode_attention.launches,
            wops.wkv6.launches) == before


@pytest.mark.parametrize("kernel", ["flash", "decode", "wkv6"])
def test_non_cpu_tensor_launches_or_raises(kernel):
    """A tensor that is not on the CPU never takes the plain version."""
    q = torch.zeros((1, 1, 2, 32), device="meta")
    k = torch.zeros((1, 16, 1, 32), device="meta")
    with pytest.raises(ValueError, match="not cuda"):
        if kernel == "flash":
            flash_attention(q, q, q, causal=True)
        elif kernel == "decode":
            decode_attention(q, k, k, torch.zeros((1, 16), device="meta"))
        else:
            wops.wkv6(k, k, k, k, torch.zeros((16, 32), device="meta"))


def _c_params(src: Path, fn: str) -> int:
    sig = re.search(rf"int {fn}\((.*?)\)\s*{{", src.read_text(), re.S)
    return len(sig.group(1).split(","))


def test_c_entries_match_the_ctypes_bindings():
    srcs = _build.sources()
    assert set(srcs) == {"flash_attention", "decode_attention", "wkv6"}
    # the ctypes bindings declare one argument per C parameter
    assert _c_params(srcs["flash_attention"], "flash_attention_fwd") == \
        len(fops.ARGTYPES)
    assert _c_params(srcs["decode_attention"], "decode_attention_fwd") == \
        len(dops.ARGTYPES)
    assert _c_params(srcs["wkv6"], "wkv6_fwd") == len(wops.ARGTYPES)
    for name in srcs:
        assert _build._library_path(srcs[name]).parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert set(_launch.HEAD_DIMS) == {32, 64, 80, 112, 128}


@pytest.mark.parametrize("const,attr", [("CH", "SLOTS_PER_BLOCK"),
                                        ("MAXG", "MAX_GROUP")])
def test_decode_wrapper_constants_match_the_kernel(const, attr):
    """The wrapper sizes the partials and checks the group from Python
    copies of the kernel's constants; they must agree with the source."""
    src = _build.sources()["decode_attention"].read_text()
    m = re.search(rf"constexpr int {const} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(dops, attr)
