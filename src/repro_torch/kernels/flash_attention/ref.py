"""Plain PyTorch version of flash attention (causal / windowed GQA).

A copy of `repro/kernels/flash_attention/ref.py::flash_attention_ref`.
"""
import math

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q (B,S,H,d), k/v (B,S,K,d) with H % K == 0. fp32 softmax."""
    B, S, H, d = q.shape
    K = k.shape[2]
    g = H // K
    qg = q.reshape(B, S, K, g, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    s = s / math.sqrt(d)
    pos = torch.arange(S, device=q.device)
    dlt = pos[:, None] - pos[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (dlt >= 0)
    if window is not None:
        ok = ok & (dlt < window)
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(B, S, H, d)
