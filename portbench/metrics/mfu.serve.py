"""Serve step (`train/steps.py` `make_prefill` / `make_serve_step`):
model FLOPs of the window's batches (the frozen `model_flops_per_step`:
2 N_active a token plus attention; a prefill over its prompt, each
decode step over the keys up to its token) over the window's seconds
times the bf16 peak, 989 TFLOP/s."""
from portbench.flops import PEAK_FLOPS, model_flops


def read(run):
    w, m = run.work, run.model
    B, P, G = w["batch"], w["prompt_len"], w["gen"]
    per_batch = model_flops(m, "prefill", B, P) + sum(
        model_flops(m, "decode", B, P + i + 1) for i in range(G - 1))
    return w["batches"] * per_batch / run.window_s / PEAK_FLOPS["bfloat16"]
