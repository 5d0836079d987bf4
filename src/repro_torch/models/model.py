"""Model assembly for the decoder families: init / forward / decode.

Port of `repro.models.model` for dense decoders, MoE, the Mamba +
attention hybrid (Jamba) and RWKV6. Parameters keep the reference's tree:
per-position-in-period layer dicts whose leaves carry a leading period
axis. The reference's `lax.scan` over periods is a Python loop over that
axis here. Caches (KV rings, Mamba conv and SSM states, RWKV shift and WKV
states) are updated in place, so the reference's two `cache_in_carry`
decode branches (which compute the same function) are one index write.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# the ROADMAP.md queue 1 item that ports each family the port does not
# run yet
_LATER = {
    "vlm": "item 7 (VLM and whisper: cross_attention)",
    "audio": "item 7 (VLM and whisper: the whisper encoder)",
}


def _require_supported(cfg: ModelConfig) -> None:
    """Raise for the cross-attention families (VLM, whisper)."""
    if cfg.cross_attn_every or cfg.encoder_layers:
        later = _LATER.get(cfg.family, "item 7")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): repro_torch runs the dense, MoE, "
            f"hybrid (Mamba) and RWKV6 decoders so far; ROADMAP.md queue 1 "
            f"{later} ports this family")


# ---------------------------------------------------------------------------
# Block structure
# ---------------------------------------------------------------------------


def period_of(cfg: ModelConfig) -> int:
    _require_supported(cfg)
    if cfg.rwkv:
        return 1
    if cfg.attn_every > 1:
        return cfg.attn_every
    if cfg.moe is not None and cfg.moe_every > 1:
        return cfg.moe_every
    return 1


def block_specs(cfg: ModelConfig) -> list[dict]:
    """One spec per position within a period: the mixer (attn, mamba,
    rwkv) and the FFN (dense, moe, rwkv)."""
    P = period_of(cfg)
    specs = []
    for pos in range(P):
        if cfg.rwkv:
            specs.append({"kind": "rwkv", "ffn": "rwkv"})
            continue
        kind = "mamba" if cfg.attn_every > 1 and pos != P - 1 else "attn"
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


def _attn_params(gen, cfg: ModelConfig, tp: int):
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
        p["attn"] = _attn_params(gen, cfg, tp)
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
    return params


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _at(tree, i):
    """The i-th slice along the leading (period) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(p, spec, x, cfg, *, cache=None, cache_index=None,
                 mode="train", use_kernels=True):
    """One block. Returns (x, aux): the block's MoE load-balance loss, or
    None for a block without one (the reference adds a 0 there). New cache
    entries are written into `cache` in place."""
    aux = None
    if spec["kind"] == "rwkv":
        return _apply_rwkv_block(p, x, cfg, cache, use_kernels), aux
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec["kind"] == "mamba":
        st = cache["mamba"] if cache is not None else None
        o, mst = L.mamba(p["mamba"], h, cfg, state=st)
        if cache is not None:
            for name, new in mst.items():
                cache["mamba"][name].copy_(new)
    elif mode == "decode":
        o, _ = L.decode_attention(p["attn"], h, cfg, cache=cache["kv"],
                                  cache_index=cache_index,
                                  use_kernels=use_kernels)
    else:
        kvc_in = cache["kv"] if cache is not None else None
        o, _ = L.self_attention(p["attn"], h, cfg,
                                causal=spec.get("causal", cfg.causal),
                                kv_cache=kvc_in,
                                cache_index=0 if kvc_in is not None
                                else None, use_kernels=use_kernels)
    x = x + o
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec["ffn"] == "moe":
        o, aux = L.moe_ffn(p["moe"], h, cfg.moe)
    else:
        o = L.swiglu(p["ffn"], h)
    return x + o, aux


def _apply_rwkv_block(p, x, cfg, cache, use_kernels):
    """An RWKV6 block (train, prefill and decode alike). The new shift and
    WKV states are written into `cache` in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    o, tm_state = L.rwkv_time_mix(p["time_mix"], h, cfg,
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


def _embed(params, cfg, tokens):
    return params["embed"][tokens]


def _unembed(params, cfg, x):
    head = params.get("lm_head", params["embed"])
    return L._einsum("bsd,vd->bsv", x, head)


def _run_layers(params, cfg, x, caches, *, remat=False, **kw):
    """The periods in order. Returns (x, aux): aux summed over the blocks
    in the reference's order."""
    specs = block_specs(cfg)

    def period(x, aux, li):
        for i, spec in enumerate(specs):
            cc = None if caches is None else _at(caches["layers"][i], li)
            x, a = _apply_block(_at(params["layers"][i], li), spec, x, cfg,
                                cache=cc, **kw)
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


def forward(params, cfg: ModelConfig, tokens, *, caches=None,
            use_kernels=True, remat=True):
    """Full-sequence forward (train, or prefill when caches are given).

    Returns (logits, aux_loss, new_caches); aux_loss is the MoE blocks'
    load-balance loss summed over the blocks (0 without MoE). `remat`
    recomputes each period in the backward; it applies only when autograd
    records and no caches are given. The caches' tensors are written in
    place; new_caches shares them and carries the advanced index.
    """
    x = _embed(params, cfg, tokens)
    x, aux = _run_layers(params, cfg, x, caches, mode="train",
                         use_kernels=use_kernels,
                         remat=remat and caches is None
                         and torch.is_grad_enabled())
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x)
    out_caches = None
    if caches is not None:
        out_caches = {**caches, "index": caches["index"] + tokens.shape[1]}
    return logits, aux, out_caches


def decode_step(params, cfg: ModelConfig, token, caches, *,
                use_kernels=True):
    """One-token decode. token (B,1). Returns (logits, new_caches).

    The caches' tensors are written in place; new_caches shares them and
    carries the advanced index.
    """
    index = caches["index"]
    x = _embed(params, cfg, token)
    x, _ = _run_layers(params, cfg, x, caches, cache_index=index,
                       mode="decode", use_kernels=use_kernels)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), {**caches, "index": index + 1}


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                dtype=torch.bfloat16, *, device) -> dict:
    """Zeroed caches: KV rings of W = min(max_len, sliding window) slots;
    Mamba conv states (in `dtype`) and SSM states (float32); RWKV6's shift
    states (in `dtype`) and WKV states (float32). `index` is an int (the
    next position to write)."""
    specs = block_specs(cfg)
    n_periods = cfg.num_layers // len(specs)
    hd = cfg.head_dim_()

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
        _, Kp, _ = cfg.padded_heads(tp)
        W = min(max_len, cfg.sliding_window or max_len)
        return {"kv": {"k": zeros(W, Kp, hd), "v": zeros(W, Kp, hd)}}
    return {"index": 0, "layers": [one(s) for s in specs]}
