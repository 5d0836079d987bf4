"""Each run's diagnostics: where its window's time went, and the state of
the host, the card and the allocator around the window, so that a run
that reads slow can be told from one whose host or card was slow. They
sit in the result line beside the metrics and are never a metric.

The window's own clock readings (serving: each batch and, within it,
serve's `prefill_s` and `decode_s`; training: each step) are summarised
as median, minimum and maximum, and the mean of the first three beside
the mean of the rest. Around the window: the allocator's retries and
cudaMalloc / cudaFree calls and reserved bytes, the host's load
average, the CPUs the process may run on, the process's CPU seconds over
the window's, and Python's cyclic collector. At each clock reading
inside the window: the card's SM clock and power draw from NVML. Nothing
is added inside a batch or a step. A field that a run cannot read, and
every card field of a CPU run, reads "not measured".
"""
from __future__ import annotations

import gc
import os
import resource
import statistics
import time

NOT = "not measured"
ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free")


def summary(xs: list):
    """Median, minimum and maximum of a series, and the mean of its first
    three beside the mean of the rest."""
    if not xs:
        return NOT
    return {"n": len(xs), "median": statistics.median(xs), "min": min(xs),
            "max": max(xs), "first3_mean": statistics.fmean(xs[:3]),
            "rest_mean": statistics.fmean(xs[3:]) if len(xs) > 3 else NOT}


def _nvml(device):
    """A reader of (SM clock MHz, power W) through torch's NVML calls, or
    None where pynvml does not import or NVML does not answer."""
    import torch
    try:
        import pynvml
    except ImportError:
        return None

    def read():
        return (float(torch.cuda.clock_rate(device)),
                torch.cuda.power_draw(device) / 1e3)
    try:
        read()
    except (pynvml.NVMLError, RuntimeError):
        return None
    return read


class Probe:
    """open() before the window's first clock reading, sample() at each
    reading inside it, close() after its last; report() after the run."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.reader = _nvml(device) if self.cuda else None
        self.samples = []           # (SM clock MHz, power W)
        self.gc_s = 0.0
        self._gc_t = None
        self.before = self.after = None

    def _state(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        s = {"t": time.perf_counter(), "load": list(os.getloadavg()),
             "cpu_s": ru.ru_utime + ru.ru_stime,
             "gc": [g["collections"] for g in gc.get_stats()]}
        if self.cuda:
            import torch
            st = torch.cuda.memory_stats(self.device)
            s["alloc"] = {k: st.get(k) for k in ALLOC}
            s["reserved"] = st.get("reserved_bytes.all.current")
        return s

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    def open(self):
        self.before = self._state()
        gc.callbacks.append(self._on_gc)

    def sample(self):
        if self.reader is not None:
            self.samples.append(self.reader())

    def close(self):
        gc.callbacks.remove(self._on_gc)
        self.after = self._state()

    def report(self, series: dict) -> dict:
        """The diagnostics object of the result line; `series` holds the
        window's own readings in seconds, one per batch or step."""
        b, a = self.before, self.after
        wall = a["t"] - b["t"]
        out = {k: summary(v) for k, v in series.items()}
        out["host"] = {
            "loadavg_before": b["load"], "loadavg_after": a["load"],
            "affinity_cpus": len(os.sched_getaffinity(0)),
            "cpu_count": os.cpu_count(),
            "process_cpu_share": (a["cpu_s"] - b["cpu_s"]) / wall,
            "gc_collections": [x - y for x, y in zip(a["gc"], b["gc"])],
            "gc_s": self.gc_s}
        if self.cuda:
            out["allocator"] = {
                k: (a["alloc"][k] - b["alloc"][k]
                    if a["alloc"][k] is not None else NOT) for k in ALLOC}
            out["allocator"]["reserved_bytes_before"] = b["reserved"]
            out["allocator"]["reserved_bytes_after"] = a["reserved"]
        else:
            out["allocator"] = {k: NOT for k in ALLOC}
        card = {"sm_clock_mhz": NOT, "power_w": NOT, "samples": 0}
        if self.samples:
            for i, k in enumerate(("sm_clock_mhz", "power_w")):
                xs = [s[i] for s in self.samples]
                card[k] = {"median": statistics.median(xs), "min": min(xs)}
            card["samples"] = len(self.samples)
        out["card"] = card
        return out
