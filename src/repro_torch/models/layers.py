"""Dense decoder layers (port of the dense subset of `repro.models.layers`).

Conventions
-----------
* Parameters are plain dicts of tensors with the reference's keys and
  einsum layouts: wq (D,H',hd), wk/wv (D,K',hd), wo (H',hd,D).
* Weights carry TP-aligned padded head counts (see
  ModelConfig.padded_heads): padded q heads have zero Wq columns / zero Wo
  rows, so the function equals the unpadded architecture exactly.
* KV caches are written in place (an index write into the cache tensor,
  which may be a view of the stacked per-layer cache); the reference
  returns updated copies instead.
* `use_kernels=True` runs attention through the CUDA kernels (their plain
  versions for CPU tensors); `False` selects the reference's plain paths.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops

NEG_BIG = -1e30


def _einsum(eq, *ops):
    """torch.einsum over operands promoted to one dtype, as jnp.einsum
    promotes mixed dtypes (a bf16 cache under a float32 model)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, d). positions: (..., S). Split halves rotate."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions[..., :, None].float() * freqs      # (...,S,half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mask_bias(q_pos, k_pos, causal, window):
    """(..., Sq, Sk) additive bias; q_pos (...,Sq), k_pos (...,Sk)."""
    d = q_pos[..., :, None] - k_pos[..., None, :]
    ok = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
    if window is not None:
        ok = ok & (d < window)
    return torch.full(ok.shape, NEG_BIG, dtype=torch.float32,
                      device=ok.device).masked_fill_(ok, 0.0)


# ---------------------------------------------------------------------------
# Attention (GQA + RoPE + qk-norm + SWA)
# ---------------------------------------------------------------------------


def _attn_core_chunked(q, k, v, q_pos, k_pos, causal, window, block=512):
    """Online-softmax attention looped over key blocks (plain flash).

    q (B,Sq,H,d), k/v (B,Sk,K,d), *_pos (B,S). fp32 accumulation.
    """
    B, Sq, Hq, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    group = Hq // Kv
    nb = max(1, Sk // block)
    block = Sk // nb
    if nb * block != Sk:
        raise ValueError(f"key length {Sk} is not a multiple of block "
                         f"{block}")
    qg = q.reshape(B, Sq, Kv, group, dh).float() / math.sqrt(dh)
    m = torch.full((B, Kv, group, Sq), NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Kv, group, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, group, Sq, dh), dtype=torch.float32,
                      device=q.device)
    for i in range(nb):
        sl = slice(i * block, (i + 1) * block)
        kb, vb, kp = k[:, sl], v[:, sl], k_pos[:, sl]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kb.float())
        d = q_pos[:, None, None, :, None] - kp[:, None, None, None, :]
        ok = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
        if window is not None:
            ok = ok & (d < window)
        s = torch.where(ok, s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _einsum(
            "bkgst,btkd->bkgsd", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dh).to(v.dtype)


def _attn_core(q, k, v, bias):
    """q (B,Sq,H,d), k/v (B,Sk,K,d), bias (B,Sq,Sk) additive fp32."""
    B, Sq, Hq, dh = q.shape
    Kv = k.shape[2]
    group = Hq // Kv
    qg = q.reshape(B, Sq, Kv, group, dh)
    scores = _einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(dh)
    scores = scores + bias[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return _einsum("bkgst,btkd->bskgd", w, v).reshape(B, Sq, Hq, dh)


def _qkv(p, x, src, cfg):
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    k = _einsum("bsd,dhk->bshk", src, p["wk"])
    v = _einsum("bsd,dhk->bshk", src, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _proj_out(p, o):
    return _einsum("bshk,hkd->bsd", o, p["wo"])


def self_attention(p, x, cfg, *, causal=None, use_rope=True, kv_cache=None,
                   cache_index=None, use_kernels=True):
    """Self-attention over a full sequence (prefill).

    p: {wq (D,H',hd), wk/wv (D,K',hd), wo (H',hd,D), [qn, kn (hd,)]}
    If kv_cache is given, writes the (tail of the) new K/V into it in place
    at cache_index (an int) and returns (out, kv_cache); attention itself
    always runs over the freshly computed full-sequence K/V.
    """
    causal = cfg.causal if causal is None else causal
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, x, cfg)
    start = 0 if cache_index is None else cache_index
    positions = (start + torch.arange(S, dtype=torch.int32, device=x.device)
                 )[None, :].expand(B, S)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache["k"], kv_cache["v"]
        W = ck.shape[1]
        ar = torch.arange(min(S, W), device=x.device)
        if S >= W:                       # ring smaller than prefill: keep tail
            widx = ((cache_index + S - W) % W + ar) % W
            ck[:, widx] = k[:, -W:].to(ck.dtype)
            cv[:, widx] = v[:, -W:].to(cv.dtype)
        else:
            widx = (cache_index + ar) % W
            ck[:, widx] = k.to(ck.dtype)
            cv[:, widx] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
    if use_kernels:
        o = fops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal,
                                 window=cfg.sliding_window)
    elif getattr(cfg, "attn_block", None):
        o = _attn_core_chunked(q, k, v, positions, positions, causal,
                               cfg.sliding_window, block=cfg.attn_block)
    else:
        bias = _mask_bias(positions, positions, causal, cfg.sliding_window)
        o = _attn_core(q, k, v, bias)
    return _proj_out(p, o), new_cache


def decode_attention(p, x, cfg, *, cache, cache_index: int, use_rope=True,
                     use_kernels=True):
    """Single-token (Sq=1) self-attention over a KV cache (ring for SWA).

    Writes the new K/V into `cache` in place at slot cache_index % W.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode_attention takes one token, got {S}")
    q, k, v = _qkv(p, x, x, cfg)
    pos = torch.full((B, 1), cache_index, dtype=torch.int32, device=x.device)
    if use_rope:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    W = ck.shape[1]
    slot = cache_index % W
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    slots = torch.arange(W, device=x.device)[None, :]
    # ring semantics hold for full caches too: unwritten future slots get
    # negative positions and are masked invalid. torch's % is a floor-mod,
    # as jnp's is.
    kv_pos = cache_index - ((cache_index - slots) % W)
    valid = (kv_pos >= 0) & (kv_pos <= cache_index)
    bias = torch.full((B, W), NEG_BIG, dtype=torch.float32,
                      device=x.device).masked_fill_(valid, 0.0)
    if use_kernels:
        o = dops.decode_attention(q.contiguous(), ck, cv, bias)
    else:
        o = _attn_core(q, ck, cv, bias[:, None, :])
    return _proj_out(p, o), {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# FFN: SwiGLU dense
# ---------------------------------------------------------------------------


def swiglu(p, x):
    g = _einsum("bsd,df->bsf", x, p["w_gate"])
    u = _einsum("bsd,df->bsf", x, p["w_up"])
    return _einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"])
