"""Serve entry (`launch/serve.py`): the mean decode step, serve's own
`decode_s` (host clock after a synchronize) summed over the window's
batches, over their decode steps."""


def read(run):
    w = run.work
    steps = w["batches"] * (w["gen"] - 1)
    return sum(w["decode_s"]) / steps * 1e3 if steps else None
