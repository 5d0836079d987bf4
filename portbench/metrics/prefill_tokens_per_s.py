"""Serve entry (`launch/serve.py`): prompt tokens over serve's own
`prefill_s` (host clock after a synchronize), summed over the window."""


def read(run):
    w = run.work
    s = sum(w["prefill_s"])
    return w["batches"] * w["batch"] * w["prompt_len"] / s if s else None
