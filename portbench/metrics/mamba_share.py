"""Model (`models/layers.py`): the share of the window inside
`layers.mamba` calls, by CUDA events around each call."""

SPANS = ["repro_torch.models.layers:mamba"]


def read(run):
    s = run.trace.spans.get(SPANS[0], 0.0)
    return s / run.window_s if s else None
