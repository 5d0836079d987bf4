"""Model assembly for dense decoders: init / prefill forward / decode.

Port of the dense subset of `repro.models.model`. Parameters keep the
reference's tree: per-position-in-period layer dicts whose leaves carry a
leading period axis. The reference's `lax.scan` over periods is a Python
loop over that axis here. KV caches are updated in place, so the
reference's two `cache_in_carry` decode branches (which compute the same
function) are one index write.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# what ROADMAP.md queue 1 item ports each family the port does not run yet
_LATER = {
    "moe": "item 7 (MoE: moe_ffn)",
    "vlm": "item 7 (VLM and whisper: cross_attention)",
    "audio": "item 7 (VLM and whisper: the whisper encoder)",
    "hybrid": "item 7 (Mamba), with MoE",
    "ssm": "item 7 (RWKV6) and TPU-kernel queue item 3 (wkv6_fwd)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.moe is not None or cfg.rwkv
            or cfg.attn_every > 1 or cfg.cross_attn_every
            or cfg.encoder_layers):
        later = _LATER.get(cfg.family, "item 7")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): repro_torch runs dense decoders "
            f"only so far; ROADMAP.md queue 1 {later} ports this family")


# ---------------------------------------------------------------------------
# Block structure
# ---------------------------------------------------------------------------


def period_of(cfg: ModelConfig) -> int:
    _require_dense(cfg)
    return 1


def block_specs(cfg: ModelConfig) -> list[dict]:
    """One spec per position within a period."""
    return [{"kind": "attn", "ffn": "dense"} for _ in range(period_of(cfg))]


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


def _ffn_params(gen, cfg: ModelConfig):
    D, Fd = cfg.d_model, cfg.d_ff
    dt = _dtype(cfg.param_dtype)
    return {"w_gate": _dense(gen, (D, Fd), dt),
            "w_up": _dense(gen, (D, Fd), dt),
            "w_down": _dense(gen, (Fd, D), dt,
                             0.02 / math.sqrt(2 * cfg.num_layers))}


def _block_params(gen, cfg: ModelConfig, spec: dict, tp: int):
    return {"ln1": _norm_init(gen, cfg.d_model),
            "ln2": _norm_init(gen, cfg.d_model),
            "attn": _attn_params(gen, cfg, tp),
            "ffn": _ffn_params(gen, cfg)}


def _stack(trees: list):
    """Stack a list of equal-structure dicts of tensors leafwise."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig, tp: int = 1) -> dict:
    """Random parameters on `gen.device`, in the reference's tree."""
    P = period_of(cfg)
    specs = block_specs(cfg)
    n_periods = cfg.num_layers // P
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
    """One block. Returns (x, new_cache)."""
    new_cache = cache
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        o, kvc = L.decode_attention(p["attn"], h, cfg, cache=cache["kv"],
                                    cache_index=cache_index,
                                    use_kernels=use_kernels)
        new_cache = {**cache, "kv": kvc}
    else:
        kvc_in = cache["kv"] if cache is not None else None
        o, kvc = L.self_attention(p["attn"], h, cfg,
                                  causal=spec.get("causal", cfg.causal),
                                  kv_cache=kvc_in,
                                  cache_index=0 if kvc_in is not None
                                  else None, use_kernels=use_kernels)
        if cache is not None:
            new_cache = {**cache, "kv": kvc}
    x = x + o
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.swiglu(p["ffn"], h), new_cache


def _embed(params, cfg, tokens):
    return params["embed"][tokens]


def _unembed(params, cfg, x):
    head = params.get("lm_head", params["embed"])
    return L._einsum("bsd,vd->bsv", x, head)


def _run_layers(params, cfg, x, caches, **kw):
    specs = block_specs(cfg)
    for li in range(cfg.num_layers // len(specs)):
        for i, spec in enumerate(specs):
            cc = None if caches is None else _at(caches["layers"][i], li)
            x, _ = _apply_block(_at(params["layers"][i], li), spec, x, cfg,
                                cache=cc, **kw)
    return x


def forward(params, cfg: ModelConfig, tokens, *, caches=None,
            use_kernels=True):
    """Full-sequence forward (prefill when caches are given).

    Returns (logits, aux_loss, new_caches); aux_loss is 0 for dense models.
    The caches' tensors are written in place; new_caches shares them and
    carries the advanced index.
    """
    x = _embed(params, cfg, tokens)
    x = _run_layers(params, cfg, x, caches, mode="train",
                    use_kernels=use_kernels)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
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
    x = _run_layers(params, cfg, x, caches, cache_index=index,
                    mode="decode", use_kernels=use_kernels)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x), {**caches, "index": index + 1}


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                dtype=torch.bfloat16, *, device) -> dict:
    """Zeroed KV caches; W = min(max_len, sliding window). `index` is an
    int (the next position to write)."""
    specs = block_specs(cfg)
    n_periods = cfg.num_layers // len(specs)
    hd = cfg.head_dim_()
    _, Kp, _ = cfg.padded_heads(tp)
    W = min(max_len, cfg.sliding_window or max_len)
    shape = (n_periods, batch, W, Kp, hd)

    def one(spec):
        return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}}
    return {"index": 0, "layers": [one(s) for s in specs]}
