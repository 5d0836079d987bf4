"""Decoder layers: the dense subset of `repro.models.layers`, cross-attention,
the MoE FFN, Mamba and RWKV6.

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
* `use_kernels=True` runs attention and the WKV6 recurrence through the
  CUDA kernels (their plain versions for CPU tensors); `False` selects the
  reference's plain paths. The MoE dispatch and the Mamba scan are plain
  PyTorch on both, as they are plain jnp in the reference.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.kernels.rwkv6.ref import wkv6_chunked as _wkv6_chunked

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
# Attention (GQA + RoPE + qk-norm + SWA + cross-attn)
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


def cross_attention(p, x, cfg, *, kv=None, cache=None):
    """Cross-attention to a fixed source (image tokens / encoder output).

    Either `kv` (source activations (B,T,D), prefill: k and v are projected
    from it and returned as the new {k, v}) or `cache` ({k, v} precomputed,
    decode: only q is projected) must be given. No mask and no rope; the
    plain `_attn_core`, as in the reference, which runs no kernel here.
    Returns (out, {k, v}); `out` is scaled by tanh(gate) where p has a
    `gate` (llama-3.2-vision's gated cross-attention layers).
    """
    B, S, _ = x.shape
    if cache is None:
        q, k, v = _qkv(p, x, kv, cfg)
    else:
        q = _einsum("bsd,dhk->bshk", x, p["wq"])
        if cfg.qk_norm:
            q = rms_norm(q, p["qn"], cfg.norm_eps)
        k, v = cache["k"], cache["v"]
    bias = torch.zeros((B, S, k.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = _proj_out(p, _attn_core(q, k, v, bias))
    if "gate" in p:
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# FFN: SwiGLU dense + token-choice top-k MoE (GShard-style einsum dispatch)
# ---------------------------------------------------------------------------


def swiglu(p, x):
    g = _einsum("bsd,df->bsf", x, p["w_gate"])
    u = _einsum("bsd,df->bsf", x, p["w_up"])
    return _einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"])


def _moe_route(p, xt, moe_cfg):
    """Shared routing: returns (gate_vals, expert_ids, pos, C, probs).

    Router logits in float32 (a bf16 `xt` times the float32 router
    promotes); top-k of the softmax, renormalised; each (token, k)'s
    position within its expert counted in (k-major, token) order; gates of
    positions past the capacity C are 0.
    """
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    N = xt.shape[0]
    logits = _einsum("nd,de->ne", xt, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)          # (N,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    C = max(1, int(moe_cfg.capacity_factor * K * N / E))
    onehot = F.one_hot(expert_ids, E)                             # (N,K,E)
    flat = onehot.transpose(0, 1).reshape(K * N, E)
    pos_flat = torch.cumsum(flat, dim=0) - flat                   # (K*N,E)
    pos = (pos_flat.reshape(K, N, E).transpose(0, 1) * onehot).sum(-1)
    keep = (pos < C).to(gate_vals.dtype)
    return gate_vals * keep, expert_ids, pos, C, probs


def _moe_aux(expert_ids, probs, moe_cfg):
    """Load-balance loss on the first choice only."""
    E = moe_cfg.num_experts
    f = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    pm = probs.mean(0)
    return E * torch.sum(f * pm) * moe_cfg.aux_loss_weight


def _expert_ffn(p, xe):
    g = _einsum("ecd,edf->ecf", xe, p["w_gate"])
    u = _einsum("ecd,edf->ecf", xe, p["w_up"])
    return _einsum("ecf,efd->ecd", F.silu(g) * u, p["w_down"])


def moe_ffn(p, x, moe_cfg):
    """Token-choice top-k MoE.

    p: {router (D,E) float32, w_gate/w_up (E,D,F), w_down (E,F,D),
        [shared: swiglu params]}
    Returns (out, aux_loss). Dispatch per moe_cfg.dispatch:
      'einsum'  -- GShard one-hot einsums: 2*N*E*C*D dispatch FLOP;
      'scatter' -- index_add_ into the expert slots, a gather back.
    Tokens past an expert's capacity are dropped (their gate is 0).
    """
    B, S, D = x.shape
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    N = B * S
    xt = x.reshape(N, D)
    gate_vals, expert_ids, pos, C, probs = _moe_route(p, xt, moe_cfg)

    if moe_cfg.dispatch == "scatter":
        slot = expert_ids * C + pos                               # (N,K)
        slot = torch.where(gate_vals > 0, slot, E * C)           # overflow bin
        xe = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=xt.device)
        xe.index_add_(0, slot.reshape(-1),
                      xt[:, None, :].expand(N, K, D).reshape(-1, D))
        ye = _expert_ffn(p, xe[:E * C].reshape(E, C, D))
        back = ye.reshape(E * C, D)[
            torch.clamp(slot, 0, E * C - 1).reshape(-1)].reshape(N, K, D)
        out = torch.sum(back * gate_vals[..., None].to(back.dtype), dim=1)
    elif moe_cfg.dispatch == "einsum":
        # dispatch / combine tensors (N,E,C) built one k at a time. The
        # reference's one_hot(pos, C) is a zero row for pos >= C, which is
        # how overflow tokens drop out: the comparison with arange(C) gives
        # the same zero row (F.one_hot would raise instead)
        slots = torch.arange(C, device=xt.device)
        xe = torch.zeros((E, C, D), dtype=xt.dtype, device=xt.device)
        combine = torch.zeros((N, E, C), dtype=torch.float32,
                              device=xt.device)
        for k in range(K):
            d_k = (F.one_hot(expert_ids[:, k], E).to(xt.dtype)[:, :, None]
                   * (pos[:, k, None] == slots).to(xt.dtype)[:, None, :])
            d_k = d_k * (gate_vals[:, k] > 0)[:, None, None].to(xt.dtype)
            xe = xe + _einsum("nec,nd->ecd", d_k, xt)
            combine = combine + (d_k.float()
                                 * gate_vals[:, k, None, None])
            del d_k
        ye = _expert_ffn(p, xe)
        out = _einsum("nec,ecd->nd", combine.to(ye.dtype), ye)
    else:
        raise ValueError(f"unknown MoE dispatch {moe_cfg.dispatch!r}")

    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + swiglu(p["shared"], x)
    return out, _moe_aux(expert_ids, probs, moe_cfg)


# ---------------------------------------------------------------------------
# Mamba (selective SSM): chunked scan, decode single-step
# ---------------------------------------------------------------------------

MAMBA_CHUNK = 256


def _scan_pairs(a, b):
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under the
    reference's combine (a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2): the
    log-step (Hillis-Steele) doubling, ceil(log2 c) vectorised steps in
    place of `lax.associative_scan`'s tree (the same function, rounded in
    another order)."""
    c, s = a.shape[1], 1
    while s < c:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def _mamba_ssm_chunked(dt, A, Bm, Cm, xin, h0):
    """h_t = exp(dt_t*A) h_{t-1} + dt_t*B_t*x_t ; y_t = C_t . h_t.

    dt,xin: (B,S,I)  Bm,Cm: (B,S,Nst)  A: (I,Nst)  h0: (B,I,Nst)
    Returns y (B,S,I), h_final. Chunks of c = S // max(1, S // 256) tokens
    (S must be a multiple of their count, as the reference's reshape
    needs); dA and dBx, (B,c,I,Nst) each, are formed a chunk at a time
    where the reference forms them for all of S at once.
    """
    Bsz, S, I = xin.shape
    nchunk = max(1, S // MAMBA_CHUNK)
    c = S // nchunk
    if nchunk * c != S:
        raise ValueError(f"sequence length {S} is not a multiple of its "
                         f"{nchunk} chunks")
    h, ys = h0, []
    for i in range(nchunk):
        sl = slice(i * c, (i + 1) * c)
        dA = torch.exp(dt[:, sl, :, None] * A)                 # (B,c,I,N)
        dBx = (dt[:, sl] * xin[:, sl])[..., None] * Bm[:, sl, None, :]
        aa, bb = _scan_pairs(dA, dBx)
        del dA, dBx
        h_all = aa * h[:, None] + bb                           # (B,c,I,N)
        del aa, bb
        ys.append(torch.einsum("bcin,bcn->bci", h_all, Cm[:, sl]))
        h = h_all[:, -1].clone()
        del h_all
    return torch.cat(ys, dim=1), h


def mamba(p, x, cfg, *, state=None):
    """Mamba-1 selective SSM block.

    p: {in_proj (D, 2I), conv_w (dc, I), conv_b (I,), x_proj (I, R+2N),
        dt_proj (R, I), dt_bias (I,), A_log (I,N), Dskip (I,), out_proj (I,D)}
    state: {conv: (B, dc-1, I), ssm: (B,I,N) float32} for prefill into a
    cache and decode. Returns (out, new_state). The SSM runs in float32,
    the conv, skip and gate in the model's dtype. `F.softplus` switches to
    the identity above 20 where `jax.nn.softplus` does not; the two agree
    to float32 rounding there.
    """
    m = cfg.mamba
    B, S, D = x.shape
    I = m.expand * D
    xz = _einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = xz[..., :I], xz[..., I:]
    # depthwise causal conv over seq (dc taps), in the reference's order
    dc = m.d_conv
    if state is not None:
        ctx = torch.cat([state["conv"], xin], dim=1)      # (B,dc-1+S,I)
    else:
        ctx = F.pad(xin, (0, 0, dc - 1, 0))
    conv = sum(ctx[:, i:i + S] * p["conv_w"][i] for i in range(dc))
    xin_c = F.silu(conv + p["conv_b"])
    new_conv = ctx[:, -(dc - 1):] if dc > 1 else ctx[:, :0]

    R = p["dt_proj"].shape[0]
    N = m.d_state
    dbc = _einsum("bsi,ir->bsr", xin_c, p["x_proj"])
    dt_r, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = F.softplus(_einsum("bsr,ri->bsi", dt_r, p["dt_proj"])
                    + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    h0 = state["ssm"] if state is not None else torch.zeros(
        (B, I, N), dtype=torch.float32, device=x.device)
    y, h_last = _mamba_ssm_chunked(dt.float(), A, Bm.float(), Cm.float(),
                                   xin_c.float(), h0)
    y = y.to(x.dtype) + xin_c * p["Dskip"]
    y = y * F.silu(z)
    out = _einsum("bsi,id->bsd", y, p["out_proj"])
    return out, {"conv": new_conv, "ssm": h_last}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay WKV; its chunked parallel form,
# `_wkv6_chunked`, lives beside the kernel, whose backward is its autograd
# ---------------------------------------------------------------------------


def _lora(x, p, act=torch.tanh):
    return _einsum("bsr,rd->bsd", act(_einsum("bsd,dr->bsr", x, p["a"])),
                   p["b"])


def _shifted(x, state):
    """x shifted one token right: the previous token at each position,
    `state` (B,1,D) or zeros before the first."""
    if state is not None:
        return torch.cat([state, x[:, :-1]], dim=1)
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def rwkv_time_mix(p, x, cfg, *, state=None, use_kernels=True):
    """RWKV6 time-mix with data-dependent decay.

    p: {mu_r/k/v/g/w (D,), w0 (D,), w_lora {a (D,r), b (r,D)},
        wr/wk/wv/wg (D,H,hd), wo (H,hd,D), u (H,hd), ln_x (H*hd,)}
    state: {shift (B,1,D), wkv (B,H,hd,hd)}
    Returns (out, new_state); the recurrence runs in float32. The kernel
    starts from a zero state, so it runs only without `state` (training);
    prefill (zeroed caches) and decode take the chunked form, as in the
    reference.
    """
    B, S, D = x.shape
    H, hd = p["u"].shape
    prev = _shifted(x, None if state is None else state["shift"])

    def mix(mu):
        return x + (prev - x) * mu
    xr, xk, xv, xg, xw = (mix(p[f"mu_{n}"]) for n in "rkvgw")
    r = _einsum("bsd,dhk->bhsk", xr, p["wr"])
    k = _einsum("bsd,dhk->bhsk", xk, p["wk"])
    v = _einsum("bsd,dhk->bhsk", xv, p["wv"])
    g = F.silu(_einsum("bsd,dhk->bhsk", xg, p["wg"]))
    # data-dependent decay (the Finch contribution)
    wdyn = p["w0"] + _lora(xw, p["w_lora"])                  # (B,S,D)
    logw = -torch.exp(wdyn.float())                           # <= 0
    logw = logw.reshape(B, S, H, hd).permute(0, 2, 1, 3)
    rf, kf, vf, uf = (t.float().contiguous() for t in (r, k, v, p["u"]))
    if use_kernels and state is None:
        out, S_fin = wops.wkv6(rf, kf, vf, logw.contiguous(), uf)
    else:
        S0 = state["wkv"] if state is not None else torch.zeros(
            (B, H, hd, hd), dtype=torch.float32, device=x.device)
        out, S_fin = _wkv6_chunked(rf, kf, vf, logw, uf, S0)
    # group norm per head (population variance)
    out = out.permute(0, 2, 1, 3)                             # (B,S,H,hd)
    mu_ = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu_) * torch.rsqrt(var + 64e-5)
    out = (out.reshape(B, S, H * hd) * p["ln_x"]).to(x.dtype)
    out = out * g.permute(0, 2, 1, 3).reshape(B, S, H * hd)
    out = _einsum("bshk,hkd->bsd", out.reshape(B, S, H, hd), p["wo"])
    return out, {"shift": x[:, -1:], "wkv": S_fin}


def rwkv_channel_mix(p, x, *, state=None):
    """p: {mu_k, mu_r (D,), wk (D,F), wv (F,D), wr (D,D)}. Returns (out,
    new_state (B,1,D))."""
    prev = _shifted(x, state)
    xk = x + (prev - x) * p["mu_k"]
    xr = x + (prev - x) * p["mu_r"]
    kk = torch.square(F.relu(_einsum("bsd,df->bsf", xk, p["wk"])))
    vv = _einsum("bsf,fd->bsd", kk, p["wv"])
    rr = torch.sigmoid(_einsum("bsd,de->bse", xr, p["wr"]))
    return rr * vv, x[:, -1:]
