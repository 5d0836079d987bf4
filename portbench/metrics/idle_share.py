"""Device: the traced window less the union of the device's kernel and
copy spans, over the window. Nothing where the device did nothing."""


def read(run):
    t = run.trace
    if not t.busy_s or not t.trace_window_s:
        return None
    return 1.0 - t.busy_s / t.trace_window_s
