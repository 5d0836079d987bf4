"""The traced run's instruments, all from the benchmark's own files:
torch.profiler over the measured window (the CUDA activity only: the
device's kernels and copies, without the host-side recording of every
operator, which more than doubled a host-bound decode step), CUDA
events around wrapped calls into the program (spans), the shapes of the
calls a roofline needs, and host spans (the wall clock, which the
profiler's device timestamps are on) that name what the host was doing.
Nothing is added inside the program: a wrapped function is replaced by
its wrapper on its module for the window only."""
from __future__ import annotations

import contextlib
import functools
import importlib
import re
import time

import numpy as np
import torch


def resolve(target: str):
    """(module, attribute name) of "package.module:function"."""
    mod, name = target.split(":")
    return importlib.import_module(mod), name


class Tracer:
    """spans: targets timed by CUDA events; calls: {roofline name:
    roofline module}, whose WRAPS target records each call's shapes;
    factories: {target: label} of factories whose products' calls are
    annotated. Use start() and stop() around the window, then view()."""

    def __init__(self, spans=(), calls=None, factories=None, cuda=True):
        self.cuda = cuda
        self.span_events = {t: [] for t in spans}
        self.call_records = {n: [] for n in (calls or {})}
        self._calls = dict(calls or {})
        self._factories = dict(factories or {})
        self._real = {}
        self._prof = None
        self.host = []              # (start ns, end ns, label)

    # -- wrappers -----------------------------------------------------------

    def _wrap(self, target, fn):
        label = target.split(":")[1]
        events = self.span_events.get(target)
        recorders = [(n, r) for n, r in self._calls.items()
                     if r.WRAPS == target]
        cuda = self.cuda

        def call(*args, **kwargs):
            for n, r in recorders:
                self.call_records[n].append(r.record(*args, **kwargs))
            with self.annotate(label):
                if events is None or not cuda:
                    return fn(*args, **kwargs)
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*args, **kwargs)
                e.record()
                events.append((s, e))
                return out
        # the program may read or count attributes of the function
        # (`flash_attention.launches`): the wrapper carries them
        return functools.update_wrapper(call, fn)

    def _wrap_factory(self, target, fn):
        """A factory (make_prefill, make_serve_step) whose products are
        annotated."""
        label = self._factories[target]

        def make(*args, **kwargs):
            inner = fn(*args, **kwargs)

            def call(*a, **k):
                with self.annotate(label):
                    return inner(*a, **k)
            return call
        return functools.update_wrapper(make, fn)

    def start(self):
        targets = set(self.span_events) | {r.WRAPS for r in
                                           self._calls.values()}
        for t in sorted(targets):
            mod, name = resolve(t)
            self._real[t] = getattr(mod, name)
            setattr(mod, name, self._wrap(t, self._real[t]))
        for t in sorted(self._factories):
            mod, name = resolve(t)
            self._real[t] = getattr(mod, name)
            setattr(mod, name, self._wrap_factory(t, self._real[t]))
        acts = [torch.profiler.ProfilerActivity.CUDA if self.cuda
                else torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.time_ns()

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        for t, fn in self._real.items():
            mod, name = resolve(t)
            setattr(mod, name, fn)
        self._real = {}

    @contextlib.contextmanager
    def annotate(self, name: str):
        """A host span: what the host is doing until the block ends."""
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.host.append((t0, time.time_ns(), name))

    def view(self, window_s: float) -> "TraceView":
        spans = {t: sum(s.elapsed_time(e) for s, e in ev) / 1e3
                 for t, ev in self.span_events.items()}
        return TraceView(self._prof, (self.t0, self.t1), self.host,
                         window_s, spans, self.call_records)


class TraceView:
    """What the readers read: device kernels by name, the device's busy
    time within the window, spans and recorded calls."""

    def __init__(self, prof, bounds, host, window_s, spans, calls):
        self.window_s = window_s
        self.spans = spans
        self.calls = calls
        self.t0, self.t1 = bounds
        cuda = torch.autograd.DeviceType.CUDA
        self.gpu = [(e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == cuda and e.end_ns() > self.t0
                    and e.start_ns() < self.t1]
        self.notes = host
        self.trace_window_s = (self.t1 - self.t0) / 1e9
        self._merged = self._merge()
        self.busy_s = float(sum(e - s for s, e in self._merged)) / 1e9

    def _merge(self):
        if not self.gpu:
            return np.zeros((0, 2), dtype=np.int64)
        iv = np.array([(max(s, self.t0), min(e, self.t1))
                       for s, e, _ in self.gpu], dtype=np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        out = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return np.array(out, dtype=np.int64)

    def kernel(self, pattern: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches."""
        rx = re.compile(pattern)
        hit = [e - s for s, e, n in self.gpu if rx.search(n)]
        return float(sum(hit)) / 1e9, len(hit)

    def device_ops(self, top=10) -> list:
        tot: dict = {}
        for s, e, n in self.gpu:
            tot[n] = tot.get(n, 0) + (e - s)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v / 1e9] for n, v in best]

    def idle_gaps(self, top=10) -> list:
        """Idle device time within the window, summed by the innermost
        host span the host was inside at each gap's middle."""
        m = self._merged
        if len(m) == 0:
            return [["no device work", self.trace_window_s]]
        starts = np.concatenate([[self.t0], m[:, 1]])
        ends = np.concatenate([m[:, 0], [self.t1]])
        gaps = ends - starts
        keep = gaps > 0
        starts, gaps = starts[keep], gaps[keep]
        mids = starts + gaps // 2
        label = np.full(len(mids), -1, dtype=np.int64)
        names = sorted({n for _, _, n in self.notes})
        index = {n: i for i, n in enumerate(names)}
        for s, e, n in sorted(self.notes, key=lambda x: x[0] - x[1]):
            lo, hi = np.searchsorted(mids, [s, e])
            label[lo:hi] = index[n]
        tot: dict = {}
        for lab, g in zip(label.tolist(), gaps.tolist()):
            key = names[lab] if lab >= 0 else "between calls"
            tot[key] = tot.get(key, 0) + g
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in best]

