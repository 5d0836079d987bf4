"""Train step (`train/steps.py`, `optim/`): model FLOPs of the window's
steps (the frozen `model_flops_per_step`: 6 N tokens plus attention,
recomputation not counted) over the window's seconds times the bf16
peak, 989 TFLOP/s."""
from portbench.flops import PEAK_FLOPS, model_flops


def read(run):
    w = run.work
    flops = w["steps"] * model_flops(run.model, "train", w["batch"],
                                     w["seq_len"])
    return flops / run.window_s / PEAK_FLOPS["bfloat16"]
