"""Model (`models/layers.py`): the share of the window inside
`layers.moe_ffn` calls, by CUDA events around each call."""

SPANS = ["repro_torch.models.layers:moe_ffn"]


def read(run):
    s = run.trace.spans.get(SPANS[0], 0.0)
    return s / run.window_s if s else None
