"""Model assembly for every family: init / forward / decode.

Port of `repro.models.model`: dense decoders, MoE, the Mamba + attention
hybrid (Jamba), RWKV6, the VLM (gated cross-attention every
`cross_attn_every` layers) and whisper (an encoder over audio frames, and
a decoder with a cross-attention sublayer in every block). Parameters keep
the reference's tree: per-position-in-period layer dicts whose leaves
carry a leading period axis. The reference's `lax.scan` over periods is a
Python loop over that axis here. Caches (KV rings, Mamba conv and SSM
states, RWKV shift and WKV states, cross-attention k and v) are updated in
place, so the reference's two `cache_in_carry` decode branches (which
compute the same function) are one index write.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.rules import reduce_partials, tp_only
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# Block structure
# ---------------------------------------------------------------------------


def period_of(cfg: ModelConfig) -> int:
    if cfg.rwkv:
        return 1
    if cfg.attn_every > 1:
        return cfg.attn_every
    if cfg.cross_attn_every:
        return cfg.cross_attn_every
    if cfg.moe is not None and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def block_specs(cfg: ModelConfig) -> list[dict]:
    """One spec per position within a period: the mixer (attn, xattn,
    mamba, rwkv) and the FFN (dense, moe, rwkv); whisper's decoder blocks
    carry `cross` (a cross-attention sublayer after the self-attention)."""
    P = period_of(cfg)
    specs = []
    for pos in range(P):
        if cfg.rwkv:
            specs.append({"kind": "rwkv", "ffn": "rwkv"})
            continue
        if cfg.encoder_layers:   # whisper decoder: self + cross every layer
            specs.append({"kind": "attn", "ffn": "dense", "cross": True})
            continue
        if cfg.attn_every > 1:
            kind = "attn" if pos == P - 1 else "mamba"
        elif cfg.cross_attn_every and pos == P - 1:
            kind = "xattn"
        else:
            kind = "attn"
        if cfg.moe is not None and (pos % cfg.moe_every
                                    == cfg.moe_every - 1):
            ffn = "moe"
        else:
            ffn = "dense"
        specs.append({"kind": kind, "ffn": ffn})
    return specs


# ---------------------------------------------------------------------------
# Parameter init (same shapes, dtypes and scales as the reference; values
# come from a torch.Generator, on the generator's device)
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _zeros(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _norm_init(gen, d):
    return _zeros(gen, (d,), torch.float32)


def _dense(gen, shape, dtype, scale=0.02):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def _attn_params(gen, cfg: ModelConfig, tp: int, *, cross=False):
    D, hd = cfg.d_model, cfg.head_dim_()
    H, K = cfg.num_heads, cfg.num_kv_heads
    Hp, Kp, Gp = cfg.padded_heads(tp)
    G = H // K
    dt = _dtype(cfg.param_dtype)
    out_scale = 0.02 / math.sqrt(2 * cfg.num_layers)
    # real weights, then scatter into the padded / group-aligned layout
    wq = _dense(gen, (D, K, G, hd), dt, out_scale)
    K_eff = Kp if K >= tp else K          # K>=tp: zero-pad kv groups too
    wq_p = _zeros(gen, (D, K_eff, Gp, hd), dt)
    wq_p[:, :K, :G] = wq
    wk = _dense(gen, (D, K, hd), dt)
    wv = _dense(gen, (D, K, hd), dt)
    if K < tp:
        r = tp // K
        wk_p = wk.repeat_interleave(r, dim=1)
        wv_p = wv.repeat_interleave(r, dim=1)
    else:
        wk_p = _zeros(gen, (D, Kp, hd), dt)
        wv_p = _zeros(gen, (D, Kp, hd), dt)
        wk_p[:, :K] = wk
        wv_p[:, :K] = wv
    wo = _dense(gen, (K, G, hd, D), dt, out_scale)
    wo_p = _zeros(gen, (K_eff, Gp, hd, D), dt)
    if K >= tp:
        wo_p[:K, :G] = wo
    else:
        wo_p[:, :G] = wo
    p = {"wq": wq_p.reshape(D, Hp, hd), "wk": wk_p, "wv": wv_p,
         "wo": wo_p.reshape(Hp, hd, D)}
    if cfg.qk_norm:
        p["qn"] = _norm_init(gen, hd)
        p["kn"] = _norm_init(gen, hd)
    if cross:                   # the VLM's tanh gate, 0 at init
        p["gate"] = _zeros(gen, (), torch.float32)
    return p


def _ffn_params(gen, cfg: ModelConfig, d_ff=None):
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    return {"w_gate": _dense(gen, (D, Fd), dt),
            "w_up": _dense(gen, (D, Fd), dt),
            "w_down": _dense(gen, (Fd, D), dt,
                             0.02 / math.sqrt(2 * cfg.num_layers))}


def _moe_params(gen, cfg: ModelConfig):
    m = cfg.moe
    D, Fd, E = cfg.d_model, m.d_ff, m.num_experts
    dt = _dtype(cfg.param_dtype)
    p = {"router": _dense(gen, (D, E), torch.float32),
         "w_gate": _dense(gen, (E, D, Fd), dt),
         "w_up": _dense(gen, (E, D, Fd), dt),
         "w_down": _dense(gen, (E, Fd, D), dt,
                          0.02 / math.sqrt(2 * cfg.num_layers))}
    if m.num_shared_experts:
        p["shared"] = _ffn_params(gen, cfg, d_ff=Fd * m.num_shared_experts)
    return p


def _mamba_params(gen, cfg: ModelConfig):
    m = cfg.mamba
    D = cfg.d_model
    I = m.expand * D
    R = max(1, D // 16)
    N = m.d_state
    dt = _dtype(cfg.param_dtype)
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=gen.device).expand(I, N)
    return {
        "in_proj": _dense(gen, (D, 2 * I), dt),
        "conv_w": _dense(gen, (m.d_conv, I), dt, 0.1),
        "conv_b": _zeros(gen, (I,), dt),
        "x_proj": _dense(gen, (I, R + 2 * N), dt),
        "dt_proj": _dense(gen, (R, I), dt),
        "dt_bias": torch.full((I,), -2.0, dtype=dt, device=gen.device),
        "A_log": torch.log(A),
        "Dskip": torch.ones((I,), dtype=dt, device=gen.device),
        "out_proj": _dense(gen, (I, D), dt,
                           0.02 / math.sqrt(2 * cfg.num_layers)),
    }


def _rwkv_params(gen, cfg: ModelConfig):
    D = cfg.d_model
    hd = cfg.head_dim_()
    H = D // hd
    r_lora = max(8, D // 64)
    dt = _dtype(cfg.param_dtype)
    f32 = torch.float32

    def full(value, dtype):
        return torch.full((D,), value, dtype=dtype, device=gen.device)
    tm = {f"mu_{n}": full(0.5, dt) for n in "rkvgw"}
    tm.update({
        "w0": full(-1.5, f32),
        "w_lora": {"a": _dense(gen, (D, r_lora), f32),
                   "b": _dense(gen, (r_lora, D), f32)},
        "wr": _dense(gen, (D, H, hd), dt),
        "wk": _dense(gen, (D, H, hd), dt),
        "wv": _dense(gen, (D, H, hd), dt),
        "wg": _dense(gen, (D, H, hd), dt),
        "wo": _dense(gen, (H, hd, D), dt,
                     0.02 / math.sqrt(2 * cfg.num_layers)),
        "u": _dense(gen, (H, hd), f32),
        "ln_x": full(1.0, f32),
    })
    cm = {"mu_k": full(0.5, dt), "mu_r": full(0.5, dt),
          "wk": _dense(gen, (D, cfg.d_ff), dt),
          "wv": _dense(gen, (cfg.d_ff, D), dt),
          "wr": _dense(gen, (D, D), dt)}
    return {"time_mix": tm, "channel_mix": cm}


def _block_params(gen, cfg: ModelConfig, spec: dict, tp: int):
    p = {"ln1": _norm_init(gen, cfg.d_model),
         "ln2": _norm_init(gen, cfg.d_model)}
    if spec["kind"] == "rwkv":
        return {**p, **_rwkv_params(gen, cfg)}
    if spec["kind"] == "mamba":
        p["mamba"] = _mamba_params(gen, cfg)
    else:
        p["attn"] = _attn_params(gen, cfg, tp,
                                 cross=spec["kind"] == "xattn")
        if spec.get("cross"):
            p["ln_x"] = _norm_init(gen, cfg.d_model)
            p["xattn"] = _attn_params(gen, cfg, tp)
    if spec["ffn"] == "moe":
        p["moe"] = _moe_params(gen, cfg)
    else:
        p["ffn"] = _ffn_params(gen, cfg)
    return p


def _stack(trees: list):
    """Stack a list of equal-structure dicts of tensors leafwise (one
    period: a view, so a full-width layer is not held twice)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if len(trees) == 1:
        return trees[0].unsqueeze(0)
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig, tp: int = 1) -> dict:
    """Random parameters on `gen.device`, in the reference's tree."""
    P = period_of(cfg)
    specs = block_specs(cfg)
    n_periods = cfg.num_layers // P
    if n_periods * P != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"whole number of {P}-layer periods")
    Vp = cfg.padded_vocab()
    dt = _dtype(cfg.param_dtype)
    embed = _zeros(gen, (Vp, cfg.d_model), dt)
    embed[:cfg.vocab_size] = _dense(gen, (cfg.vocab_size, cfg.d_model), dt)
    params: dict = {"embed": embed,
                    "final_norm": _norm_init(gen, cfg.d_model)}
    if not cfg.tie_embeddings:
        head = _zeros(gen, (Vp, cfg.d_model), dt)
        head[:cfg.vocab_size] = _dense(gen, (cfg.vocab_size, cfg.d_model), dt)
        params["lm_head"] = head
    params["layers"] = [
        _stack([_block_params(gen, cfg, spec, tp) for _ in range(n_periods)])
        for spec in specs]
    if cfg.encoder_layers:      # whisper encoder stack (self-attn, dense ffn)
        enc_spec = {"kind": "attn", "ffn": "dense"}
        params["encoder"] = {
            "layers": _stack([_block_params(gen, cfg, enc_spec, tp)
                              for _ in range(cfg.encoder_layers)]),
            "final_norm": _norm_init(gen, cfg.d_model)}
    return params


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _at(tree, i):
    """The i-th slice along the leading (period) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(p, spec, x, cfg, rules=None, *, cache=None,
                 cache_index=None, mode="train", extra=None,
                 use_kernels=True):
    """One block. Returns (x, aux): the block's MoE load-balance loss, or
    None for a block without one (the reference adds a 0 there). New cache
    entries are written into `cache` in place. Under a mesh the block's
    weights are gathered over the batch axes first (FSDP), their "model"
    sharding kept."""
    p = tree_map(tp_only, p)
    aux = None
    if spec["kind"] == "rwkv":
        return _apply_rwkv_block(p, x, cfg, rules, cache, use_kernels), aux
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec["kind"] == "mamba":
        st = cache["mamba"] if cache is not None else None
        o, mst = L.mamba(p["mamba"], h, cfg, rules, state=st)
        if cache is not None:
            for name, new in mst.items():
                cache["mamba"][name].copy_(new)
    elif spec["kind"] == "xattn":
        o = _cross(p["attn"], h, cfg, rules, cache, mode, extra)
    else:
        use_rope = not cfg.encoder_layers     # whisper: abs pos, no rope
        if mode == "decode":
            o, _ = L.decode_attention(p["attn"], h, cfg, rules,
                                      cache=cache["kv"],
                                      cache_index=cache_index,
                                      use_rope=use_rope,
                                      use_kernels=use_kernels)
        else:
            kvc_in = cache["kv"] if cache is not None else None
            o, _ = L.self_attention(p["attn"], h, cfg, rules,
                                    causal=spec.get("causal", cfg.causal),
                                    use_rope=use_rope, kv_cache=kvc_in,
                                    cache_index=0 if kvc_in is not None
                                    else None, use_kernels=use_kernels)
        if spec.get("cross"):            # whisper decoder cross-attn sublayer
            x = x + o
            h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
            o = _cross(p["xattn"], h, cfg, rules, cache, mode, extra)
    x = x + o
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec["ffn"] == "moe":
        o, aux = L.moe_ffn(p["moe"], h, cfg.moe, rules)
    else:
        o = L.swiglu(p["ffn"], h, rules)
    return x + o, aux


def _cross(p, h, cfg, rules, cache, mode, extra):
    """Cross-attention of a block: over the `xkv` cache in decode; else
    over extra["cross_source"], whose projected k and v go into the cache
    when there is one (`_fit_cross_caches` gave it their shape and
    dtype)."""
    if mode == "decode":
        return L.cross_attention(p, h, cfg, rules, cache=cache["xkv"])[0]
    o, xc = L.cross_attention(p, h, cfg, rules, kv=extra["cross_source"])
    if cache is not None:
        for name, new in xc.items():
            cache["xkv"][name].copy_(new)
    return o


def _apply_rwkv_block(p, x, cfg, rules, cache, use_kernels):
    """An RWKV6 block (train, prefill and decode alike). The new shift and
    WKV states are written into `cache` in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    o, tm_state = L.rwkv_time_mix(p["time_mix"], h, cfg, rules,
                                  state=None if cache is None else
                                  cache["tm"], use_kernels=use_kernels)
    x = x + o
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    o, cm_state = L.rwkv_channel_mix(p["channel_mix"], h,
                                     state=None if cache is None else
                                     cache["cm"])
    x = x + o
    if cache is not None:
        for name, new in tm_state.items():
            cache["tm"][name].copy_(new)
        cache["cm"].copy_(cm_state)
    return x


def _sinusoid(T, D, device, start=0):
    """(T, D) float32 absolute positions start .. start+T-1: sin, then
    cos, of pos / 10000^(2i/D)."""
    pos = torch.arange(start, start + T, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _run_encoder(params, cfg, frames, rules=None, use_kernels=True):
    """whisper's encoder over (B, T, D) frames (the conv frontend's output,
    stubbed as in the reference): absolute positions, non-causal attention
    blocks without rope, then the encoder's final norm."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    spec = {"kind": "attn", "ffn": "dense", "causal": False}
    enc = params["encoder"]
    for li in range(cfg.encoder_layers):
        x, _ = _apply_block(_at(enc["layers"], li), spec, x, cfg, rules,
                            mode="train", use_kernels=use_kernels)
    return L.rms_norm(x, tp_only(enc["final_norm"]), cfg.norm_eps)


def _embed(params, cfg, tokens, rules=None):
    x = F.embedding(tokens, tp_only(params["embed"]))
    if rules is not None:
        return rules.cs(x, "act_bsd")
    return reduce_partials(x)


def _unembed(params, cfg, x, rules=None):
    head = tp_only(params.get("lm_head", params["embed"]))
    logits = L._einsum("bsd,vd->bsv", x, head)
    if rules is not None:
        logits = rules.cs(logits, "logits_bsv")
    return logits


def _prepare_extra(params, cfg, extra, rules=None, use_kernels=True):
    """The cross-attention source: the encoder's output over
    extra["audio_frames"] (whisper), or extra["image_embeds"] (the VLM,
    whose vision tower is stubbed as in the reference); {} for the other
    families."""
    if not (cfg.encoder_layers or cfg.cross_attn_every):
        return {}
    key = "audio_frames" if cfg.encoder_layers else "image_embeds"
    if key not in extra:
        raise ValueError(f"{cfg.name} needs extra[{key!r}] (B, T, "
                         f"{cfg.d_model}) as its cross-attention source")
    src = extra[key]
    if cfg.encoder_layers:
        src = _run_encoder(params, cfg, src, rules, use_kernels)
    return {"cross_source": src}


def _fit_cross_caches(params, cfg, caches, source):
    """Give each `xkv` entry the shape and dtype of the k and v that the
    prefill projects from `source`. The reference's prefill replaces the
    entry with them, so a float32 model keeps float32 cross k and v under
    a bf16 cache; the port writes them in place, into storage made to
    match here."""
    for i, spec in enumerate(block_specs(cfg)):
        if not (spec.get("cross") or spec["kind"] == "xattn"):
            continue
        w = params["layers"][i]["xattn" if spec.get("cross") else "attn"]
        dt = torch.promote_types(source.dtype, w["wk"].dtype)
        xkv = caches["layers"][i]["xkv"]
        for name, t in xkv.items():
            shape = (t.shape[0],) + tuple(source.shape[:2]) + t.shape[3:]
            if t.dtype != dt or t.shape != shape:
                xkv[name] = torch.zeros(shape, dtype=dt, device=t.device)


def _run_layers(params, cfg, x, caches, rules=None, *, remat=False, **kw):
    """The periods in order. Returns (x, aux): aux summed over the blocks
    in the reference's order."""
    specs = block_specs(cfg)

    def period(x, aux, li):
        for i, spec in enumerate(specs):
            cc = None if caches is None else _at(caches["layers"][i], li)
            x, a = _apply_block(_at(params["layers"][i], li), spec, x, cfg,
                                rules, cache=cc, **kw)
            if a is not None:
                aux = aux + a
        return x, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.num_layers // len(specs)):
        if remat:
            # The reference saves the periods' matmul outputs
            # (dots_with_no_batch_dims_saveable); here a period keeps only
            # its input and recomputes the rest in the backward. Same
            # numbers, another memory / recompute trade.
            x, aux = checkpoint(period, x, aux, li, use_reentrant=False)
        else:
            x, aux = period(x, aux, li)
    return x, aux


def forward(params, cfg: ModelConfig, tokens, *, extra=None, rules=None,
            caches=None, use_kernels=True, remat=True):
    """Full-sequence forward (train, or prefill when caches are given).

    Returns (logits, aux_loss, new_caches); aux_loss is the MoE blocks'
    load-balance loss summed over the blocks (0 without MoE). `extra`
    holds the cross-attention families' input: "image_embeds" (B, T, D)
    for the VLM, "audio_frames" (B, T, D) for whisper. `remat` recomputes
    each period (not the encoder) in the backward; it applies only when
    autograd records and no caches are given. The caches' tensors are
    written in place (the `xkv` entries may be replaced, see
    `_fit_cross_caches`); new_caches shares them and carries the advanced
    index.
    """
    extra = _prepare_extra(params, cfg, extra or {}, rules, use_kernels)
    if caches is not None and extra:
        _fit_cross_caches(params, cfg, caches, extra["cross_source"])
    x = _embed(params, cfg, tokens, rules)
    if cfg.encoder_layers:                      # whisper decoder abs pos
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x, aux = _run_layers(params, cfg, x, caches, rules, mode="train",
                         extra=extra,
                         use_kernels=use_kernels,
                         remat=remat and caches is None
                         and torch.is_grad_enabled())
    x = L.rms_norm(x, tp_only(params["final_norm"]), cfg.norm_eps)
    logits = _unembed(params, cfg, x, rules)
    out_caches = None
    if caches is not None:
        out_caches = {**caches, "index": caches["index"] + tokens.shape[1]}
    return logits, aux, out_caches


def decode_step(params, cfg: ModelConfig, token, caches, *, rules=None,
                use_kernels=True):
    """One-token decode. token (B,1). Returns (logits, new_caches).

    The caches' tensors are written in place; new_caches shares them and
    carries the advanced index.
    """
    index = caches["index"]
    x = _embed(params, cfg, token, rules)
    if cfg.encoder_layers:
        x = x + _sinusoid(1, cfg.d_model, x.device, start=index)[0].to(
            x.dtype)
    x, _ = _run_layers(params, cfg, x, caches, rules, cache_index=index,
                       mode="decode", use_kernels=use_kernels)
    x = L.rms_norm(x, tp_only(params["final_norm"]), cfg.norm_eps)
    return _unembed(params, cfg, x, rules), {**caches, "index": index + 1}


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                dtype=torch.bfloat16, *, device, cross_len=None) -> dict:
    """Zeroed caches: KV rings of W = min(max_len, sliding window) slots;
    cross-attention k and v (`xkv`) over T = cross_len or the config's
    image tokens or audio frames; Mamba conv states (in `dtype`) and SSM
    states (float32); RWKV6's shift states (in `dtype`) and WKV states
    (float32). `index` is an int (the next position to write)."""
    specs = block_specs(cfg)
    n_periods = cfg.num_layers // len(specs)
    hd = cfg.head_dim_()
    _, Kp, _ = cfg.padded_heads(tp)

    def zeros(*shape, dt=dtype):
        return torch.zeros((n_periods, batch) + shape, dtype=dt,
                           device=device)

    def one(spec):
        D = cfg.d_model
        if spec["kind"] == "rwkv":
            return {"tm": {"shift": zeros(1, D),
                           "wkv": zeros(D // hd, hd, hd, dt=torch.float32)},
                    "cm": zeros(1, D)}
        if spec["kind"] == "mamba":
            m = cfg.mamba
            I = m.expand * D
            return {"mamba": {"conv": zeros(m.d_conv - 1, I),
                              "ssm": zeros(I, m.d_state, dt=torch.float32)}}
        c = {}
        if spec["kind"] == "attn":
            W = min(max_len, cfg.sliding_window or max_len)
            c["kv"] = {"k": zeros(W, Kp, hd), "v": zeros(W, Kp, hd)}
        if spec.get("cross") or spec["kind"] == "xattn":
            T = cross_len or cfg.num_image_tokens or cfg.num_audio_frames
            c["xkv"] = {"k": zeros(T, Kp, hd), "v": zeros(T, Kp, hd)}
        return c
    return {"index": 0, "layers": [one(s) for s in specs]}
