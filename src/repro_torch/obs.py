"""The port's own spans and counters: where a serve call or a train step
spends its time, layer by layer, and what the MoE router did.

    from repro_torch import obs
    obs.enable()
    toks, stats, _ = serve(cfg, ...)
    records = obs.drain()

Off by default, and then free: `span` returns one shared no-op context,
a `spanned` function calls straight through, and `count` returns at
once; call sites test `enabled()` before they build a counter. The cost
is one module-global check a call.

On, `span(name, timed=False, **attrs)` records, for each block it
encloses, a dict:

- `name`, `id`, and `parent`, the id of the span open around it (None at
  the top);
- `batch`: the `batch` attr of the span or of the nearest span around it
  that has one (`serve` gives each call a batch id; a request is (batch
  id, row)), else None;
- `start_ns`, `end_ns`: `time.time_ns()` at the block's ends on the
  host, the clock torch.profiler's device timestamps are on;
- `device_s`: for a `timed` span while CUDA is in use, the seconds
  between two CUDA events recorded at the block's ends on the current
  stream, read only by `drain`; else None. Only spans whose device time
  is read are timed: the others cost a record and two host clock reads;
- `attrs`, and `counts`: {counter name: int}, the sum of what `count`
  added while the span was the innermost open one.

The events come from a pool, made by `enable()` where CUDA is already in
use and else by the first timed span once it is, and given back by
`drain()`: a timed span records two events and creates none until the
pool runs out. A counter's value is an int, a tensor, or a function of
no arguments that returns one of these; `drain` sums the tensors and
calls the functions, so counting launches nothing and never
synchronizes (what a counter's function holds stays alive until then).

Records stay in memory until `drain()` returns them. The stack of open
spans is one for the process, not one a thread: autograd runs the
backward of CUDA tensors on a thread of its own while the calling thread
waits in it, and the spans of a remat recompute belong inside the
backward's span. A span is closed when its block ends, by an exception
too (a remat recompute stops early by one). Inside a CUDA graph capture
a span would record its events at capture only, and never at a replay;
the port captures no graphs.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import time

import torch

# CUDA events made at once, when the pool is empty: a traced window of the
# jamba serving cell takes about 10,000
POOL = 16384

_on = False
_stack: list = []       # open spans, innermost last
_spans: list = []       # spans in the order they opened
_pool: list = []        # CUDA events made ahead, for timed spans
_ids = itertools.count(1)


_OFF = contextlib.nullcontext()      # every span while tracing is off


def _fill() -> None:
    """Adds POOL events to the pool, each recorded once so that CUDA
    creates it now rather than at a span's first record."""
    for _ in range(POOL):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        _pool.append(e)


class _Span:
    __slots__ = ("rec", "events")

    def __init__(self, name, timed, attrs):
        parent = _stack[-1].rec if _stack else None
        batch = attrs.pop("batch", None)
        if batch is None and parent is not None:
            batch = parent["batch"]
        self.rec = {"name": name, "id": next(_ids),
                    "parent": parent["id"] if parent else None,
                    "batch": batch, "start_ns": None, "end_ns": None,
                    "device_s": None, "attrs": attrs, "counts": {}}
        self.events = None
        if timed and torch.cuda.is_initialized():
            if len(_pool) < 2:
                _fill()
            self.events = (_pool.pop(), _pool.pop())

    def __enter__(self):
        _stack.append(self)
        _spans.append(self)
        if self.events is not None:
            self.events[0].record()
        # the clock torch.profiler's device timestamps are on
        self.rec["start_ns"] = time.time_ns()  # simlint: ok[DET002]
        return self

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.time_ns()  # simlint: ok[DET002]
        if self.events is not None:
            self.events[1].record()
        _stack.pop()
        return False


def enabled() -> bool:
    return _on


def enable() -> None:
    """Starts recording; makes the events' pool where CUDA is in use."""
    global _on
    _on = True
    if not _pool and torch.cuda.is_initialized():
        _fill()


def disable() -> None:
    """Stops recording; what was recorded stays until drained."""
    global _on
    _on = False


def span(name: str, timed: bool = False, **attrs):
    """A context that records the block it encloses, on the device too
    where `timed` (see the module docstring); the shared no-op context
    while tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, timed, attrs)


def spanned(name: str, timed: bool = False):
    """A decorator: each call of the function runs in `span(name,
    timed)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, timed, {}):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value) -> None:
    """Adds `value` (an int, a tensor, or a function that returns one,
    summed or called at `drain`) to counter `name` of the innermost open
    span; nothing while tracing is off or no span is open."""
    if _on and _stack:
        _stack[-1].rec["counts"].setdefault(name, []).append(value)


def _total(vals) -> int:
    out = 0
    for v in vals:
        if callable(v):
            v = v()
        out += int(v.sum()) if isinstance(v, torch.Tensor) else int(v)
    return out


def drain() -> list:
    """The records of the spans closed so far, in the order they opened,
    with their device seconds and counter sums filled in; they are kept
    no longer, and their events go back to the pool. Synchronizes the
    device once, where spans recorded CUDA events."""
    global _spans
    done = [s for s in _spans if s.rec["end_ns"] is not None]
    _spans = [s for s in _spans if s.rec["end_ns"] is None]
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    out = []
    for s in done:
        rec = s.rec
        if s.events is not None:
            rec["device_s"] = s.events[0].elapsed_time(s.events[1]) / 1e3
            _pool.extend(s.events)
            s.events = None
        rec["counts"] = {k: _total(vals) for k, vals in rec["counts"].items()}
        out.append(rec)
    return out


def seconds(rec) -> float:
    """A record's device seconds where it has them, else its host
    seconds."""
    if rec["device_s"] is not None:
        return rec["device_s"]
    return (rec["end_ns"] - rec["start_ns"]) / 1e9
