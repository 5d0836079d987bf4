"""Serve step (`train/steps.py` `make_prefill` / `make_serve_step`) of a
layer-pattern model (Nemotron-H): model FLOPs of the window's batches
over the window's seconds times the bf16 peak, 989 TFLOP/s. Its own
frozen count, as `flops.py` knows no layer pattern: 2 N_active a token,
N_active every weight a token reads but the input embedding (the Mamba-2
blocks, the attention blocks' projections, the MoE blocks' router, top-k
routed and shared experts, the norms and the head), plus causal
attention over the '*' blocks, 4 H hd a key and token, halved over a
prefill. The Mamba-2 scan is not counted."""
from portbench.flops import PEAK_FLOPS


def active_params(m: dict) -> int:
    D = m["d_model"]
    mb, mc = m["mamba"], m["moe"]
    I = mb["n_heads"] * mb["head_dim"]
    C = I + 2 * mb["n_groups"] * mb["d_state"]
    H = mb["n_heads"]
    mamba = D * (I + C + H) + C * (mb["d_conv"] + 1) + 3 * H + I + I * D
    attn = 2 * D * m["head_dim"] * (m["num_heads"] + m["num_kv_heads"])
    moe = (D * mc["num_experts"] + mc["num_experts"]
           + 2 * D * (mc["top_k"] * mc["d_ff"] + mc["shared_d_ff"]))
    blocks = {"M": mamba, "E": moe, "*": attn}
    pattern = m["layer_pattern"]
    return (sum(D + blocks[c] for c in pattern) + D
            + m["vocab_size"] * D)


def model_flops(m: dict, kind: str, batch: int, seq_len: int) -> float:
    """A prefill of `seq_len` tokens a row, or one decode step a row over
    `seq_len` keys."""
    tokens = batch * (seq_len if kind == "prefill" else 1)
    att = (4.0 * m["num_heads"] * m["head_dim"] * seq_len
           * m["layer_pattern"].count("*"))
    return 2.0 * active_params(m) * tokens + att * tokens * (
        0.5 if kind == "prefill" else 1.0)


def read(run):
    w, m = run.work, run.model
    B, P, G = w["batch"], w["prompt_len"], w["gen"]
    per_batch = model_flops(m, "prefill", B, P) + sum(
        model_flops(m, "decode", B, P + i + 1) for i in range(G - 1))
    return w["batches"] * per_batch / run.window_s / PEAK_FLOPS["bfloat16"]
