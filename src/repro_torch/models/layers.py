"""Decoder layers: the dense subset of `repro.models.layers`, cross-attention,
the MoE FFN, Mamba and RWKV6; and the port's own Mamba-2 mixer, sigmoid
router and relu² experts (Nemotron-H), which the reference lacks.

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
  reference's plain paths. The Mamba scan takes its kernel on CUDA
  tensors either way (the reference has no kernel for it, so there is no
  plain path to select) and its plain form on CPU and meta tensors. The
  MoE dispatch is plain PyTorch on both, as it is plain jnp in the
  reference.
* `rules` is an optional `ShardingRules`; `rules.cs(x, logical)`
  redistributes an activation at the reference's constraint points. Under
  a mesh the tensors are DTensors. Attention, the WKV6 recurrence and the
  Mamba conv and scan run on each rank's shard (`_per_shard`), and so do
  the MoE's routing, dispatch and combine (`_moe_sharded`), so that no
  rank computes another's share beyond what the reference's specs leave
  whole: the router over "model", the expert FFNs over the batch axes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import obs
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.mamba_scan import ops as mops
from repro_torch.kernels.mamba_scan.ref import (
    mamba_ssm_chunked as _mamba_ssm_chunked)
from repro_torch.kernels.moe_route import ops as rops
from repro_torch.kernels.moe_route.ref import route_positions_ref
from repro_torch.kernels.rwkv6 import ops as wops
from repro_torch.kernels.rwkv6.ref import wkv6_chunked as _wkv6_chunked
from repro_torch.sharding.rules import residual_carry

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


# (row dim, channel dim) of a per-shard operand, None where it has none
_BSHD = (0, 2)          # attention q, k, v, caches: (B, S, H, d)
_BHSD = (0, 1)          # wkv6 r, k, v, logw, out, state: (B, H, S, d)
_BSI = (0, 2)           # mamba dt, xin, y, conv state: (B, S, I)


def _per_shard(fn, operands, dims, out_dims=None):
    """fn(*operands) on plain tensors; where operands[0] is a DTensor, on
    each rank's shard. An operand's `dims` entry names its (row, channel)
    dims: rows are split over the mesh's pod / data axes and channels
    (attention and WKV6 heads, Mamba's inner channels) over "model",
    where every operand's dims divide. Attention, the WKV6 recurrence and
    the Mamba conv and scan are independent per row and per channel, so
    the shards' outputs, placed by `out_dims` (each output's dims; by
    default fn returns one tensor placed as operands[0]), are the outputs'
    shards. The kernels take plain tensors, so this keeps them on the
    mesh's path; the plain forms run here too, where DTensor would
    otherwise propagate each of their many small ops.

    This is `torch.distributed.tensor.experimental.local_map` with its
    placements computed here, for two reasons: they depend on which axes
    divide the operands' shapes, known only at the call; and local_map
    hands a plain-tensor operand (the decode bias) to `fn` whole, where it
    must be split with q's rows."""
    if not isinstance(operands[0], DTensor):
        return fn(*operands)
    mesh = operands[0].device_mesh
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.mesh.shape))
    rows = [n for n in names if n in ("pod", "data")]
    nrows = math.prod(sizes[n] for n in rows)
    pairs = list(zip(operands, dims))
    rowed = [(t, r) for t, (r, _) in pairs if r is not None]
    chans = [(t, c) for t, (_, c) in pairs if c is not None]
    split_rows = bool(rowed) and all(t.shape[r] % nrows == 0
                                     for t, r in rowed)
    split_chans = "model" in names and bool(chans) and all(
        t.shape[c] % sizes["model"] == 0 for t, c in chans)

    def placements(d, grad=False):
        """An operand's placements; with `grad`, its gradient's: partial
        sums over the axes that split the other operands and not it."""
        row, chan = d
        out = []
        for n in names:
            split, dim = ((split_rows, row) if n in rows else
                          (split_chans, chan) if n == "model" else
                          (False, None))
            out.append(Replicate() if not split else
                       Shard(dim) if dim is not None else
                       Partial() if grad else Replicate())
        return tuple(out)
    ins = [(t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim)).redistribute(mesh, placements(d))
        for t, d in pairs]
    out = fn(*(t.to_local(grad_placements=placements(d, grad=True))
               for t, d in zip(ins, dims)))
    if out_dims is None:
        return DTensor.from_local(out, mesh, placements(dims[0]))
    return tuple(DTensor.from_local(o, mesh, placements(d))
                 for o, d in zip(out, out_dims))


def _qkv(p, x, src, cfg, rules=None):
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    k = _einsum("bsd,dhk->bshk", src, p["wk"])
    v = _einsum("bsd,dhk->bshk", src, p["wv"])
    if rules is not None:
        q, k, v = (rules.cs(t, "act_bshd") for t in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _proj_out(p, o, rules=None):
    out = _einsum("bshk,hkd->bsd", o, p["wo"])
    if rules is not None:
        out = rules.cs(out, "act_bsd")
    return out


def _write_slots(cache, idx, new):
    """cache[:, idx] = new (in the cache's dtype), in place. Under a mesh
    on each rank's shard, `new` in the cache's placements first (torch
    2.11's DTensor has no sharding for this index write); the slot dim of
    a prefill's cache is not split."""
    new = new.to(cache.dtype)
    if isinstance(cache, DTensor):
        new = new.redistribute(cache.device_mesh, cache.placements)
        cache, new = cache.to_local(), new.to_local()
    cache[:, idx] = new


def self_attention(p, x, cfg, rules=None, *, causal=None, use_rope=True,
                   kv_cache=None, cache_index=None, use_kernels=True):
    """Self-attention over a full sequence (prefill).

    p: {wq (D,H',hd), wk/wv (D,K',hd), wo (H',hd,D), [qn, kn (hd,)]}
    If kv_cache is given, writes the (tail of the) new K/V into it in place
    at cache_index (an int) and returns (out, kv_cache); attention itself
    always runs over the freshly computed full-sequence K/V.
    """
    causal = cfg.causal if causal is None else causal
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, x, cfg, rules)
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
            _write_slots(ck, widx, k[:, -W:])
            _write_slots(cv, widx, v[:, -W:])
        else:
            widx = (cache_index + ar) % W
            _write_slots(ck, widx, k)
            _write_slots(cv, widx, v)
        new_cache = {"k": ck, "v": cv}
    if use_kernels:
        o = _per_shard(lambda q, k, v: fops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=cfg.sliding_window), (q, k, v), (_BSHD,) * 3)
    elif getattr(cfg, "attn_block", None):
        o = _per_shard(lambda q, k, v, pos: _attn_core_chunked(
            q, k, v, pos, pos, causal, cfg.sliding_window,
            block=cfg.attn_block), (q, k, v, positions),
            (_BSHD, _BSHD, _BSHD, (0, None)))
    else:
        # per shard under a mesh, as the kernel: DTensor would otherwise
        # plan the 5-d score einsums itself, which on a 3-d mesh takes
        # minutes a call
        bias = _mask_bias(positions, positions, causal, cfg.sliding_window)
        o = _per_shard(_attn_core, (q, k, v, bias),
                       (_BSHD, _BSHD, _BSHD, (0, None)))
    return _proj_out(p, o, rules), new_cache


def decode_attention(p, x, cfg, rules=None, *, cache, cache_index: int,
                     use_rope=True, use_kernels=True):
    """Single-token (Sq=1) self-attention over a KV cache (ring for SWA).

    Writes the new K/V into `cache` in place at slot cache_index % W.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode_attention takes one token, got {S}")
    q, k, v = _qkv(p, x, x, cfg, rules)
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
        o = _per_shard(lambda q, ck, cv, bias: dops.decode_attention(
            q.contiguous(), ck, cv, bias), (q, ck, cv, bias),
            (_BSHD, _BSHD, _BSHD, (0, None)))
    else:
        o = _per_shard(lambda q, ck, cv, bias: _attn_core(
            q, ck, cv, bias[:, None, :]), (q, ck, cv, bias),
            (_BSHD, _BSHD, _BSHD, (0, None)))
    return _proj_out(p, o, rules), {"k": ck, "v": cv}


def cross_attention(p, x, cfg, rules=None, *, kv=None, cache=None):
    """Cross-attention to a fixed source (image tokens / encoder output).

    Either `kv` (source activations (B,T,D), prefill: k and v are projected
    from it and returned as the new {k, v}) or `cache` ({k, v} precomputed,
    decode: only q is projected) must be given. No mask and no rope; the
    plain `_attn_core`, as in the reference, which runs no kernel here
    (per shard under a mesh, as self-attention's plain path).
    Returns (out, {k, v}); `out` is scaled by tanh(gate) where p has a
    `gate` (llama-3.2-vision's gated cross-attention layers).
    """
    B, S, _ = x.shape
    if cache is None:
        q, k, v = _qkv(p, x, kv, cfg, rules)
    else:
        q = _einsum("bsd,dhk->bshk", x, p["wq"])
        if cfg.qk_norm:
            q = rms_norm(q, p["qn"], cfg.norm_eps)
        k, v = cache["k"], cache["v"]
    if rules is not None:
        q = rules.cs(q, "act_bshd")
    bias = torch.zeros((B, S, k.shape[1]), dtype=torch.float32,
                       device=x.device)
    o = _per_shard(_attn_core, (q, k, v, bias),
                   (_BSHD, _BSHD, _BSHD, (0, None)))
    out = _proj_out(p, o, rules)
    if "gate" in p:
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# FFN: SwiGLU dense + token-choice top-k MoE (GShard-style einsum dispatch)
# ---------------------------------------------------------------------------


def swiglu(p, x, rules=None):
    g = _einsum("bsd,df->bsf", x, p["w_gate"])
    u = _einsum("bsd,df->bsf", x, p["w_up"])
    h = F.silu(g) * u
    if rules is not None:
        h = rules.cs(h, "act_bsf")
    return _einsum("bsf,fd->bsd", h, p["w_down"])


def _relu2_hidden(spec, x, w_up):
    """relu(x w_up)^2, the hidden of a relu² FFN, by einsum `spec`."""
    return torch.square(F.relu(_einsum(spec, x, w_up)))


def relu2(p, x, rules=None):
    """Nemotron-H's FFN without a gate: w_down(relu(x w_up)^2).
    p: {w_up (D,F), w_down (F,D)}."""
    h = _relu2_hidden("bsd,df->bsf", x, p["w_up"])
    if rules is not None:
        h = rules.cs(h, "act_bsf")
    return _einsum("bsf,fd->bsd", h, p["w_down"])


FFNS = {"swiglu": swiglu, "relu2": relu2}


def _route_positions(expert_ids, E, with_counts):
    """The kernel's wrapper `route_positions` on contiguous ids (the
    plain form for CPU tensors), or the plain form itself on meta tensors,
    which hold no data for a kernel (the dry-run's trace)."""
    if expert_ids.device.type == "meta":
        return route_positions_ref(expert_ids, E, with_counts)
    return rops.route_positions(expert_ids.contiguous(), E, with_counts)


def _moe_route(p, xt, moe_cfg, n_tokens=None, offsets=None):
    """Shared routing: returns (gate_vals, expert_ids, pos, C, probs).

    Router logits in float32 (a bf16 `xt` times the float32 router
    promotes); top-k of the softmax, renormalised. With `router=
    "sigmoid_bias"`, `probs` are sigmoid scores, the top-k of the scores
    plus p["router_bias"] are chosen, and the gates are the chosen scores
    over their sum (plus 1e-20), times `routed_scaling`. Each (token,
    k)'s position within its expert is
    counted in (k-major, token) order (`_route_positions`); gates of
    positions past the capacity C are 0.

    On one rank's rows of a larger batch, C comes from the batch's
    `n_tokens`, and `offsets(counts)` maps this rank's (K, E) choice
    counts to what each (k, e) position must add: the choices of (k, e)
    on the earlier ranks and of (k' < k, e) on the other ranks. The
    positions are then the whole batch's (`_moe_sharded`).
    """
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    N = xt.shape[0]
    logits = _einsum("nd,de->ne", xt, p["router"]).float()
    if moe_cfg.router == "sigmoid_bias":
        probs = torch.sigmoid(logits)
        expert_ids = torch.topk(probs + p["router_bias"], K, dim=-1)[1]
        gate_vals = probs.gather(-1, expert_ids)
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True)
                                 + 1e-20) * moe_cfg.routed_scaling
    else:
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_ids = torch.topk(probs, K, dim=-1)      # (N,K)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    C = max(1, int(moe_cfg.capacity_factor * K * (n_tokens or N) / E))
    pos, counts = _route_positions(expert_ids, E, offsets is not None)
    if offsets is not None:
        pos = pos + offsets(counts).gather(1, expert_ids.t()).t()
    keep = (pos < C).to(gate_vals.dtype)
    gate_vals = gate_vals * keep
    if n_tokens is None and obs.enabled():
        # a route over the whole batch (a rank's rows count nothing),
        # counted when the records are drained: nothing is launched here
        g = gate_vals.detach()
        obs.count("moe.choices", N * K)
        obs.count("moe.kept", lambda: (g > 0).sum())
        obs.count("moe.slots", E * C)
        obs.count("moe.experts_hit",
                  lambda: expert_ids[g > 0].unique().numel())
    return gate_vals, expert_ids, pos, C, probs


def _moe_aux(expert_ids, probs, moe_cfg):
    """Load-balance loss on the first choice only."""
    E = moe_cfg.num_experts
    f = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    pm = probs.mean(0)
    return E * torch.sum(f * pm) * moe_cfg.aux_loss_weight


def _expert_ffn(p, xe, rules=None, activation="swiglu"):
    if activation == "relu2":
        h = _relu2_hidden("ecd,edf->ecf", xe, p["w_up"])
    else:
        g = _einsum("ecd,edf->ecf", xe, p["w_gate"])
        u = _einsum("ecd,edf->ecf", xe, p["w_up"])
        h = F.silu(g) * u
    if rules is not None:
        h = rules.cs(h, "moe_ecf")
    ye = _einsum("ecf,efd->ecd", h, p["w_down"])
    if rules is not None:
        ye = rules.cs(ye, "moe_ecd")
    return ye


@obs.spanned("model.moe", timed=True)
def moe_ffn(p, x, moe_cfg, rules=None):
    """Token-choice top-k MoE.

    p: {router (D,E) float32, [router_bias (E,) float32], [w_gate],
        w_up (E,D,F), w_down (E,F,D), [shared: the FFN params of width
        moe_cfg.shared_width()]}; the experts and the shared FFN are
    moe_cfg.activation's (`FFNS`).
    Returns (out, aux_loss). Dispatch per moe_cfg.dispatch:
      'einsum'  -- GShard one-hot einsums: 2*N*E*C*D dispatch FLOP;
      'scatter' -- index_add_ into the expert slots, a gather back.
    Tokens past an expert's capacity are dropped (their gate is 0).
    """
    B, S, D = x.shape
    if isinstance(x, DTensor):
        out, aux = _moe_sharded(p, x, moe_cfg, rules)
    else:
        xt = x.reshape(B * S, D)
        with obs.span("model.moe.route", timed=True,
                      experts=moe_cfg.num_experts):
            gate_vals, expert_ids, pos, C, probs = _moe_route(p, xt, moe_cfg)
        out = _moe_experts(xt, gate_vals, expert_ids, pos, C,
                           range(moe_cfg.num_experts), moe_cfg.dispatch,
                           lambda xe: _expert_ffn(p, xe, rules,
                                                  moe_cfg.activation))
        out = out.reshape(B, S, D)

        def aux():
            return _moe_aux(expert_ids, probs, moe_cfg)
    if "shared" in p:
        with obs.span("model.moe.shared", timed=True):
            out = out + FFNS[moe_cfg.activation](p["shared"], x, rules)
    # the loss last, as the reference orders it: a remat recompute runs
    # as far as the last tensor the backward saved
    return out, aux()


def _moe_experts(xt, gate_vals, expert_ids, pos, C, experts, dispatch, ffn):
    """The share of the experts `experts` (a range of ids) in the routed
    output of the tokens `xt` (N, D): the tokens dispatched into their
    (len(experts), C, D) slots, `ffn` on the slots, and the slots combined
    back by the gates. Choices of other experts, and positions past C,
    add nothing."""
    N, D = xt.shape
    K = expert_ids.shape[1]
    El, e0 = len(experts), experts.start
    if dispatch == "scatter":
        here = (gate_vals > 0) & (expert_ids >= e0) & (expert_ids < e0 + El)
        slot = torch.where(here, (expert_ids - e0) * C + pos,
                           El * C)                        # overflow bin
        xe = torch.zeros((El * C + 1, D), dtype=xt.dtype, device=xt.device)
        xe.index_add_(0, slot.reshape(-1),
                      xt[:, None, :].expand(N, K, D).reshape(-1, D))
        with obs.span("model.moe.experts", timed=True):
            ye = ffn(xe[:El * C].reshape(El, C, D))
        back = ye.reshape(El * C, D)[
            torch.clamp(slot, 0, El * C - 1).reshape(-1)].reshape(N, K, D)
        gates = torch.where(here, gate_vals, 0)
        return torch.sum(back * gates[..., None].to(back.dtype), dim=1)
    if dispatch == "einsum":
        # dispatch / combine tensors (N,El,C) built one k at a time. The
        # reference's one_hot(pos, C) is a zero row for pos >= C, which is
        # how overflow tokens drop out: the comparison with arange(C) gives
        # the same zero row (F.one_hot would raise instead); the comparison
        # with the ids of `experts` is its one_hot(expert_ids, E) there
        ids = torch.arange(e0, e0 + El, device=xt.device)
        slots = torch.arange(C, device=xt.device)
        xe = torch.zeros((El, C, D), dtype=xt.dtype, device=xt.device)
        combine = torch.zeros((N, El, C), dtype=torch.float32,
                              device=xt.device)
        for k in range(K):
            d_k = ((expert_ids[:, k, None] == ids).to(xt.dtype)[:, :, None]
                   * (pos[:, k, None] == slots).to(xt.dtype)[:, None, :])
            d_k = d_k * (gate_vals[:, k] > 0)[:, None, None].to(xt.dtype)
            xe = xe + _einsum("nec,nd->ecd", d_k, xt)
            combine = combine + (d_k.float()
                                 * gate_vals[:, k, None, None])
            del d_k
        with obs.span("model.moe.experts", timed=True):
            ye = ffn(xe)
        return _einsum("nec,ecd->nd", combine.to(ye.dtype), ye)
    raise ValueError(f"unknown MoE dispatch {dispatch!r}")


def _mesh_rows(mesh):
    """(row axes, their product, this rank's index along them): the mesh's
    pod / data axes, which split a batch's rows, pod-major."""
    names = mesh.mesh_dim_names
    rows = [n for n in names if n in ("pod", "data")]
    index = 0
    for n in rows:
        index = index * mesh.size(names.index(n)) + mesh.get_local_rank(n)
    return rows, math.prod(mesh.size(names.index(n)) for n in rows), index


def _moe_sharded(p, x, moe_cfg, rules=None):
    """`moe_ffn`'s routed experts under a mesh, each rank on its own shard
    as the reference's specs place the work. A rank routes its own rows
    of tokens (the router whole on every "model" rank) at the positions
    the whole batch gives them: it adds the earlier ranks' choice counts
    (one all-gather of K x E integers over the batch axes), so the routes,
    overflow included, are one device's. It dispatches its tokens into
    the slots of its "model" rank's experts; the slots, summed over the
    batch axes, take `moe_ecd`'s layout, where the expert FFNs run (whole
    over the batch axes); and it combines its tokens from its experts'
    outputs, a partial sum over "model". The gates' gradient is summed
    over "model" before the router's backward, which then runs whole on
    every "model" rank, as its forward. Returns (out, a function that
    gives the load-balance loss), as DTensors."""
    if moe_cfg.router != "softmax":
        raise NotImplementedError(f"the {moe_cfg.router!r} router has no "
                                  f"sharded path")
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    E, K = moe_cfg.num_experts, moe_cfg.top_k
    B, S, D = x.shape
    rows, nrows, r = _mesh_rows(mesh)
    nmodel = mesh.size(names.index("model")) if "model" in names else 1
    R = Replicate()
    split_rows = nrows > 1 and B % nrows == 0
    split_experts = nmodel > 1 and E % nmodel == 0
    rsplit, rpart = (Shard(0), Partial()) if split_rows else (R, R)
    msplit, mpart = (Shard(0), Partial()) if split_experts else (R, R)

    def pl(row, model):
        return tuple(row if n in rows else model if n == "model" else R
                     for n in names)

    x = x.redistribute(mesh, pl(rsplit, R))
    router = p["router"].redistribute(mesh, pl(R, R)).to_local(
        grad_placements=pl(rpart, R))

    def offsets(counts):
        every = DTensor.from_local(counts[None], mesh, pl(rsplit, R))
        every = every.full_tensor()                          # (nrows,K,E)
        other = every.sum(0) - counts
        return torch.cumsum(other, 0) - other + every[:r].sum(0)
    with obs.span("model.moe.route", timed=True, experts=E):
        gate_vals, expert_ids, pos, C, probs = _moe_route(
            {"router": router}, x.to_local(grad_placements=pl(rsplit, R))
            .reshape(-1, D), moe_cfg, n_tokens=B * S,
            offsets=offsets if split_rows else None)
    # the combine below uses the gates of this rank's experts only
    gates = DTensor.from_local(gate_vals, mesh, pl(rsplit, R)).to_local(
        grad_placements=pl(rsplit, mpart))
    El = E // nmodel if split_experts else E
    e0 = mesh.get_local_rank("model") * El if split_experts else 0

    def ffn(xe):
        xe = DTensor.from_local(xe, mesh, pl(rpart, msplit), shape=(E, C, D),
                                stride=(C * D, D, 1))
        ye = _expert_ffn(p, xe.redistribute(mesh, pl(R, msplit)), rules,
                         moe_cfg.activation)
        return ye.redistribute(mesh, pl(R, msplit)).to_local(
            grad_placements=pl(rpart, msplit))
    out = _moe_experts(x.to_local(grad_placements=pl(rsplit, mpart))
                       .reshape(-1, D), gates, expert_ids, pos, C,
                       range(e0, e0 + El), moe_cfg.dispatch, ffn)
    out = DTensor.from_local(out.reshape(-1, S, D), mesh, pl(rsplit, mpart),
                             shape=(B, S, D), stride=(S * D, D, 1))

    def aux():
        """The load-balance loss from the batch's means (of the first
        choices and the probabilities): this rank's sums, summed over the
        batch axes."""
        f, pm = (DTensor.from_local(t, mesh, pl(rpart, R)) / (B * S)
                 for t in (F.one_hot(expert_ids[:, 0], E).float().sum(0),
                           probs.sum(0)))
        return E * torch.sum(f * pm) * moe_cfg.aux_loss_weight
    return out, aux


# ---------------------------------------------------------------------------
# Mamba (selective SSM): the scan runs in `kernels/mamba_scan` (the kernel and
# its chunked plain form), prefill and decode alike
# ---------------------------------------------------------------------------


def _causal_conv(xin, conv_state, w, b):
    """Mamba's depthwise causal conv over the sequence (len(w) taps, in the
    reference's order) of xin (B,S,I) after `conv_state`, the dc - 1
    inputs before it. Returns (silu(conv + b), the new conv state)."""
    S, dc = xin.shape[1], w.shape[0]
    ctx = torch.cat([conv_state, xin], dim=1)             # (B,dc-1+S,I)
    conv = sum(ctx[:, i:i + S] * w[i] for i in range(dc))
    return F.silu(conv + b), ctx[:, ctx.shape[1] - (dc - 1):]


def _ssm_scan(dt, A, Bm, Cm, xin, h0):
    """One shard's selective scan in float32, from dt, Bm, Cm and xin in
    the model's dtype: the kernel's wrapper `mamba_scan` on contiguous
    operands (the plain form for CPU tensors), or the plain form itself on
    meta tensors, which hold no data for a kernel (the dry-run's trace)."""
    if xin.device.type == "meta":
        return _mamba_ssm_chunked(dt.float(), A, Bm.float(), Cm.float(),
                                  xin.float(), h0)
    return mops.mamba_scan(*(t.contiguous()
                             for t in (dt, A, Bm, Cm, xin, h0)))


@obs.spanned("model.mamba")
def mamba(p, x, cfg, rules=None, *, state=None):
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
    w = p["in_proj"]
    w_x, w_z = w[:, :I], w[:, I:]
    if isinstance(w, DTensor):
        # a rank's columns of in_proj fall in xin's or in z's half: each
        # half, gathered, takes the weight's layout again, so that xin
        # and z come out split over "model" with their gradients
        w_x, w_z = (t.redistribute(w.device_mesh, w.placements)
                    for t in (w_x, w_z))
    xin = _einsum("bsd,de->bse", x, w_x)
    z = _einsum("bsd,de->bse", x, w_z)
    if rules is not None:
        xin = rules.cs(xin, "act_bsf")
        z = rules.cs(z, "act_bsf")
    # depthwise causal conv over seq (dc taps), per row and channel
    dc = m.d_conv
    conv_state = state["conv"] if state is not None else torch.zeros(
        (B, dc - 1, I), dtype=xin.dtype, device=x.device)
    xin_c, new_conv = _per_shard(
        _causal_conv, (xin, conv_state, p["conv_w"], p["conv_b"]),
        (_BSI, _BSI, (None, 1), (None, 0)), out_dims=(_BSI, _BSI))

    R = p["dt_proj"].shape[0]
    N = m.d_state
    # a partial sum over "model" (I is split): reduced both ways, so that
    # neither dt's projection nor x_proj's backward gathers a weight
    dbc = residual_carry(_einsum("bsi,ir->bsr", xin_c, p["x_proj"]), rules)
    dt_r, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    dt = F.softplus(_einsum("bsr,ri->bsi", dt_r, p["dt_proj"])
                    + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    h0 = state["ssm"] if state is not None else torch.zeros(
        (B, I, N), dtype=torch.float32, device=x.device)
    # per row and inner channel: Bm and Cm are whole on every "model" rank
    with obs.span("model.mamba.scan", timed=True):
        y, h_last = _per_shard(
            _ssm_scan, (dt, A, Bm, Cm, xin_c, h0),
            (_BSI, (None, 0), (0, None), (0, None), _BSI, (0, 1)),
            out_dims=(_BSI, (0, 1)))
    y = y.to(x.dtype) + xin_c * p["Dskip"]
    y = y * F.silu(z)
    out = _einsum("bsi,id->bsd", y, p["out_proj"])
    return out, {"conv": new_conv, "ssm": h_last}


# ---------------------------------------------------------------------------
# Mamba-2 (Nemotron-H's mixer): multi-head SSD, one decay a head, B and C
# shared by groups of heads; the chunked scan in plain PyTorch
# ---------------------------------------------------------------------------


def _segsum(a):
    """(..., T) -> (..., T, T): [i, j] the sum of a over (j, i] where
    j <= i (0 on the diagonal), -inf above it. Each entry sums its own
    segment: a difference of running sums would round away the short
    segments of a long decay in float32."""
    T = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, T)               # [d, e] = a[d]
    i = torch.arange(T, device=a.device)
    s = torch.cumsum(x.masked_fill(i[:, None] <= i[None, :], 0.0), dim=-2)
    return s.masked_fill(i[:, None] < i[None, :], -math.inf)


def mamba2_chunked(x, dt, A, Bm, Cm, h0, chunk):
    """Mamba-2's scan in the chunked form of the SSD paper (Dao and Gu,
    2024, `ssd_minimal`), from the state h0, in float32:

        h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t

    for each head, one decay a head and token. x (B,S,H,P), dt (B,S,H),
    A (H,), Bm and Cm (B,S,G,N), head h reading group h // (H / G); h0
    (B,H,P,N). Within a chunk the outputs are masked products of C, B and
    x; each chunk's state at its end passes to the next in one product
    over the chunks. A ragged last chunk is padded with tokens that
    neither decay nor add. Returns (y (B,S,H,P), the state after the last
    token)."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2:]
    R, nc = H // G, -(-S // chunk)
    a = dt * A                                            # log decays
    xd = x * dt[..., None]
    pad = nc * chunk - S
    if pad:
        a, xd, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (a, xd, Bm, Cm))
    a = a.reshape(b, nc, chunk, G, R).permute(0, 1, 3, 4, 2)  # (b,c,g,r,l)
    xd = xd.reshape(b, nc, chunk, G, R, P)
    Bc, Cc = (t.reshape(b, nc, chunk, G, N) for t in (Bm, Cm))
    acs = torch.cumsum(a, dim=-1)
    # within each chunk
    L = torch.exp(_segsum(a))                             # (b,c,g,r,l,s)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)
    y = torch.einsum("bcgrls,bcsgrp->bclgrp", CB[:, :, :, None] * L, xd)
    # each chunk's inputs decayed to its end, then the state at each
    # chunk's start (and after the last) from h0 and those
    to_end = L[..., -1, :].permute(0, 1, 4, 2, 3)[..., None]
    states = torch.einsum("bcsgn,bcsgrp->bcgrpn", Bc, xd * to_end)
    states = torch.cat([h0.reshape(b, 1, G, R, P, N), states], dim=1)
    across = torch.exp(_segsum(F.pad(acs[..., -1].permute(0, 2, 3, 1),
                                     (1, 0))))       # (b,g,r,c+1,c+1)
    states = torch.einsum("bgrzc,bcgrpn->bzgrpn", across, states)
    y = y + (torch.einsum("bclgn,bcgrpn->bclgrp", Cc, states[:, :-1])
             * torch.exp(acs).permute(0, 1, 4, 2, 3)[..., None])
    return (y.reshape(b, nc * chunk, H, P)[:, :S],
            states[:, -1].reshape(b, H, P, N))


def _mamba2_step(x, dt, A, Bm, Cm, h):
    """One token of `mamba2_chunked`'s recurrence: x (B,H,P), dt (B,H),
    Bm and Cm (B,G,N), h (B,H,P,N). Returns (y (B,H,P), the new h)."""
    b, H, P = x.shape
    G, N = Bm.shape[1:]
    decay = torch.exp(dt * A).reshape(b, G, H // G, 1, 1)
    add = (x * dt[..., None]).reshape(b, G, H // G, P, 1) * \
        Bm[:, :, None, None, :]
    h = h.reshape(b, G, H // G, P, N) * decay + add
    y = torch.einsum("bgrpn,bgn->bgrp", h, Cm)
    return y.reshape(b, H, P), h.reshape(b, H, P, N)


@obs.spanned("model.mamba2", timed=True)
def mamba2(p, x, cfg, rules=None, *, state=None):
    """Mamba-2 mixer, as Nemotron-H's (transformers' NemotronHMamba2Mixer)
    computes it.

    p: {in_proj (D, I + C + H), z, xBC and dt; conv_w (dc, C), conv_b
        (C,), the depthwise causal conv over xBC, C = I + 2 G N; dt_bias,
        A_log, D (H,) float32; norm (I,) float32; out_proj (I, D)},
        I = H P.
    state: {conv: (B, dc-1, C), ssm: (B, H, P, N) float32} for prefill
    into a cache and decode. Returns (out, new_state). The conv and its
    SiLU run in the model's dtype; x, B and C are split from its output;
    dt = softplus(dt + dt_bias) and A = -exp(A_log), one a head. The scan
    (`mamba2_chunked`; one step of the recurrence for a single token),
    the skip y + D x, the gate y silu(z) and the RMSNorm over groups of
    I / G channels (scaled by 1 + norm, as the port's norms are) run in
    float32, then out_proj. No sharded path."""
    if isinstance(x, DTensor) or rules is not None:
        raise NotImplementedError("Mamba-2 has no sharded path")
    m = cfg.mamba
    B, S, _ = x.shape
    H, P, G, N = m.n_heads, m.head_dim, m.n_groups, m.d_state
    I, C = H * P, m.conv_width()
    z, xbc, dt = torch.split(_einsum("bsd,de->bse", x, p["in_proj"]),
                             [I, C, H], dim=-1)
    conv = state["conv"] if state is not None else torch.zeros(
        (B, m.d_conv - 1, C), dtype=xbc.dtype, device=x.device)
    xbc, new_conv = _causal_conv(xbc, conv, p["conv_w"], p["conv_b"])
    xs, Bm, Cm = torch.split(xbc.float(), [I, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    Bm, Cm = Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    h0 = state["ssm"] if state is not None else torch.zeros(
        (B, H, P, N), dtype=torch.float32, device=x.device)
    with obs.span("model.mamba2.scan", timed=True, tokens=B * S,
                  chunks=0 if S == 1 else -(-S // m.chunk)):
        if S == 1:
            y, h = _mamba2_step(xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                                h0)
            y = y[:, None]
        else:
            y, h = mamba2_chunked(xs, dt, A, Bm, Cm, h0, m.chunk)
    y = (y + xs * p["D"][:, None]).reshape(B, S, I) * F.silu(z.float())
    y = rms_norm(y.reshape(B, S, G, I // G), p["norm"].reshape(G, I // G),
                 cfg.norm_eps)
    out = _einsum("bsi,id->bsd", y.reshape(B, S, I).to(x.dtype),
                  p["out_proj"])
    return out, {"conv": new_conv, "ssm": h}


# ---------------------------------------------------------------------------
# RWKV6 (Finch): data-dependent decay WKV; its chunked parallel form,
# `_wkv6_chunked`, lives beside the kernel, whose backward is its autograd
# ---------------------------------------------------------------------------


def _lora(x, p, act=torch.tanh):
    return _einsum("bsr,rd->bsd", act(_einsum("bsd,dr->bsr", x, p["a"])),
                   p["b"])


def _shifted(x, state):
    """x shifted one token right: the previous token at each position,
    `state` (B,1,D) or zeros before the first (a concatenation, not a
    pad: torch 2.11's DTensor fails to plan the pad)."""
    first = torch.zeros_like(x[:, :1]) if state is None else state
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(p, x, cfg, rules=None, *, state=None, use_kernels=True):
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
        out, S_fin = _per_shard(
            wops.wkv6, (rf, kf, vf, logw.contiguous(), uf),
            (_BHSD,) * 4 + ((None, 0),), out_dims=(_BHSD, _BHSD))
    else:
        S0 = state["wkv"] if state is not None else torch.zeros(
            (B, H, hd, hd), dtype=torch.float32, device=x.device)
        out, S_fin = _per_shard(
            _wkv6_chunked, (rf, kf, vf, logw, uf, S0),
            (_BHSD,) * 4 + ((None, 0), _BHSD), out_dims=(_BHSD, _BHSD))
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
