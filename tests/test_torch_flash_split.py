"""The arithmetic of the bf16 tensor-core flash kernel, emulated on the CPU.

The kernel (src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu)
multiplies bf16 q and k into float32 scores, keeps the online softmax in
float32 over 64-key tiles (in log2 units: p = 2^(s c - m c)), and feeds
the probabilities p to the P V product as two bf16 operands, P_hi =
bf16(p) and P_lo = bf16(p - P_hi), before rounding the output to bf16. On the card it is held against the plain
version run in float32 on the same inputs to 2e-5 + 2^-8 |ref|. This file
repeats that arithmetic in plain torch and holds it to the same bound
against the reference's oracle, and shows that one bf16 rounding of p, as
FlashAttention rounds it, does not meet the bound.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import FLASH_SWEEP, both, flash_inputs, to_np  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_flash_attention_ref)

KEYS_PER_TILE = 64             # the kernel's BK
ATOL, RTOL = 2e-5, 2.0 ** -8   # the gate of chip_smoke.py phase 3
# the reference's sweep, and h2o-danube-1.8b's attention (d = 80, 32 query
# heads on 8 kv heads, a window shorter than the prompt) at a reduced S
CASES = FLASH_SWEEP + [(2, 320, 8, 2, 80, True, 256)]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def kernel_arithmetic(q, k, v, *, causal, window, split_p=True):
    """q (B,S,H,d), k/v (B,S,K,d) float32 holding bf16 values -> the
    kernel's bf16 output as float32. split_p=False rounds p to bf16 once."""
    B, S, H, d = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, d)
    # scores to log2 units, as the kernel's p = 2^(s c - m c)
    c = torch.tensor(1.0 / math.sqrt(d) * math.log2(math.e),
                     dtype=torch.float32)
    m = torch.full((B, K, H // K, S), -1e30)
    l = torch.zeros((B, K, H // K, S))
    acc = torch.zeros((B, K, H // K, S, d))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, KEYS_PER_TILE):
        kt = k[:, k0:k0 + KEYS_PER_TILE]
        vt = v[:, k0:k0 + KEYS_PER_TILE]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kt)
        cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
        ok = torch.ones((S, kt.shape[1]), dtype=torch.bool)
        if causal:
            ok &= rows >= cols
        if window is not None:
            ok &= rows - cols < window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * c)
        # a row that has seen no key yet takes m c = 0: its p is 0
        mc = torch.where(m_new == -1e30, torch.tensor(0.0), m_new * c)
        p = torch.exp2(s * c - mc[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = _bf16(p)
        pv = torch.einsum("bkgst,btkd->bkgsd", p_hi, vt)
        if split_p:
            pv = pv + torch.einsum("bkgst,btkd->bkgsd", _bf16(p - p_hi), vt)
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return _bf16(o.permute(0, 3, 1, 2, 4).reshape(B, S, H, d))


def _excess(case, split_p):
    """max(|out - ref| - RTOL |ref|) of the emulated kernel against the
    reference's oracle run in float32 on the same bf16 inputs."""
    B, S, H, K, d, causal, win = case
    q, k, v = (_bf16(torch.from_numpy(x))
               for x in flash_inputs(7, B, S, H, K, d))
    ref = to_np(jax_flash_attention_ref(*(both(to_np(x))[0]
                                          for x in (q, k, v)),
                                        causal=causal, window=win))
    out = to_np(kernel_arithmetic(q, k, v, causal=causal, window=win,
                                  split_p=split_p))
    return float(np.max(np.abs(out - ref) - RTOL * np.abs(ref)))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_p_meets_the_card_gate(case):
    assert _excess(case, split_p=True) <= ATOL


def test_one_bf16_rounding_of_p_misses_the_card_gate():
    """Why the kernel splits p: rounding it to bf16 once errs by up to
    2^-8 p |v| a term, and where |ref| is small that is beyond the gate."""
    excess = [_excess(case, split_p=False) for case in CASES]
    assert max(excess) > ATOL, excess
