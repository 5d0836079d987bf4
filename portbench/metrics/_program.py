"""Shared by the readers of the program's own spans and counters
(`repro_torch.obs`). Importing this file turns the program's tracing
on: readers are loaded only for a --trace 1 run, and before the driver
runs, so an untraced run keeps it off. A program without `obs` reads
nothing, and its readers report nothing.

The first read of a run drains the records, keeps those whose host start
lies inside the traced window, turns the tracing off (the window is
over), and adds each kept span to the trace's host spans, once: the
breakdown's idle gaps, named after the readers have run by the innermost
host span, then name the program's spans. The seconds of a span that a
reader reads are its CUDA events' on the card (the program times those
spans on the device, the others on the host only); on a CPU run its
host seconds stand in."""
try:
    from repro_torch import obs
except ImportError:             # a program from before its own spans
    obs = None
else:
    obs.enable()


def records(run) -> list:
    """The program's span records inside the window, drained once a
    run."""
    t = run.trace
    got = getattr(t, "program_records", None)
    if got is None:
        got = []
        if obs is not None:
            got = [r for r in obs.drain() if t.t0 <= r["start_ns"] <= t.t1]
            obs.disable()
        t.notes.extend((r["start_ns"], r["end_ns"], r["name"]) for r in got)
        t.program_records = got
    return got


def seconds(run, rec) -> float:
    if run.cell.device.type == "cuda":
        return rec["device_s"]
    return (rec["end_ns"] - rec["start_ns"]) / 1e9


def share(run, name):
    """The seconds inside spans `name` over the window; None where there
    are none."""
    hit = [seconds(run, r) for r in records(run) if r["name"] == name]
    return sum(hit) / run.window_s if hit else None


def under(run, name, ancestor) -> list:
    """The records `name` inside a span `ancestor`."""
    recs = records(run)
    by_id = {r["id"]: r for r in recs}

    def inside(r):
        while r["parent"] in by_id:
            r = by_id[r["parent"]]
            if r["name"] == ancestor:
                return True
        return False
    return [r for r in recs if r["name"] == name and inside(r)]
