"""Frozen arithmetic of the yardstick: the H100's datasheet peaks, a
model's FLOPs per step and its parameter counts.

A frozen copy of `repro_torch.launch.roofline.model_flops_per_step` and
of `ModelConfig.param_count`, taking the `model` dict of a configuration
file, so that a change to the program cannot change the yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB datasheet, dense, at the 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // max(m["num_heads"], 1)


def param_count(m: dict) -> tuple[int, int]:
    """(total, active) parameters of the unpadded architecture: dense
    decoders and the Mamba + attention hybrid with MoE FFNs."""
    D, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    hd = head_dim(m)
    attn_every = m.get("attn_every", 1)
    moe = m.get("moe")
    n_attn = L // attn_every if attn_every > 1 else (
        L if m["num_heads"] else 0)
    attn_p = D * (m["num_heads"] * hd) * 2 + D * (m["num_kv_heads"] * hd) * 2
    if moe is not None:
        n_moe = L // m.get("moe_every", 1)
        shared = moe.get("num_shared_experts", 0)
        moe_p = moe["num_experts"] * 3 * D * moe["d_ff"]
        moe_active = (moe["top_k"] + shared) * 3 * D * moe["d_ff"]
        shared_p = shared * 3 * D * moe["d_ff"]
        ffn_total = (n_moe * (moe_p + shared_p)
                     + (L - n_moe) * 3 * D * m["d_ff"])
        ffn_active = n_moe * moe_active + (L - n_moe) * 3 * D * m["d_ff"]
    else:
        ffn_total = ffn_active = L * 3 * D * m["d_ff"]
    if attn_every > 1:
        mb = m["mamba"]
        di = mb["expand"] * D
        mamba_p = (2 * D * di + di * mb["d_conv"]
                   + di * (mb["d_state"] * 2 + 2) + di * D)
        attn_total = n_attn * attn_p + (L - n_attn) * mamba_p
    else:
        attn_total = n_attn * attn_p
    emb = V * D * (1 if m.get("tie_embeddings") else 2)
    return (int(emb + attn_total + ffn_total),
            int(emb + attn_total + ffn_active))


def model_flops(m: dict, kind: str, batch: int, seq_len: int) -> float:
    """6*N_active*tokens for `train`, 2*N_active per token for `prefill`
    and `decode` (one token a row, attending over `seq_len` keys), plus
    attention: 4*H*hd*S_kv a token and attention layer, halved where
    causal over a whole sequence, tripled for forward and backward."""
    _, active = param_count(m)
    tokens = batch * (seq_len if kind != "decode" else 1)
    base = (6.0 if kind == "train" else 2.0) * active * tokens
    attn_every = m.get("attn_every", 1)
    n_attn = (m["num_layers"] // attn_every) if m["num_heads"] else 0
    s_kv = seq_len
    if m.get("sliding_window"):
        s_kv = min(s_kv, m["sliding_window"])
    att = 4.0 * m["num_heads"] * head_dim(m) * s_kv * n_attn
    if kind == "train":
        return base + 3.0 * att * tokens * 0.5
    if kind == "prefill":
        return base + att * tokens * 0.5
    return base + att * tokens
