#!/usr/bin/env python3
"""Where a dry-run cell's trace seconds go.

    PYTHONPATH=src python3 tools/dryrun_split.py --arch rwkv6-7b \
        --shape train_4k --mesh single --layers 1 2 [--timeout 300] \
        [--cprofile out.txt]

For each layer count it traces `repro_torch.launch.dryrun.run_cell` (not
saved) with `num_layers` overridden, in a process of its own, and splits
the wall seconds, each exclusive of the others nested in it, into:

- prop: DTensor's sharding propagation (`ShardingPropagator`'s cached
  and uncached entries, and the dispatcher's slow path around them);
- redistribute: `redistribute_local_tensor` (the collectives' local
  work: padding, chunks, concatenations);
- counter: `StepCounter.__torch_dispatch__` (each rank-local op run on
  meta tensors and accounted);
- other: the rest (the model's Python, DTensor's C++ dispatch, autograd).

A run that passes --timeout seconds is stopped and reports its split so
far. The difference between two layer counts is one layer's split. With
--cprofile the first count runs once more, under cProfile (which slows
it: its split is not reported), and its 60 costliest functions by
cumulative time go to the named file. Each run prints a line; the last
line is one JSON object of them all.
"""
from __future__ import annotations

import argparse
import json
import signal
import subprocess
import sys
import time

CATS = ("prop", "redistribute", "counter")


class _Stop(Exception):
    pass


def _instrument(totals: dict) -> None:
    """Wrap the entry points of each category in an exclusive timer."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redist
    import torch.distributed.tensor._sharding_prop as sprop
    from repro_torch.launch import dryrun as D
    stack = []           # [category, start of its running stretch]

    def timed(cat, fn):
        def wrapper(*args, **kwargs):
            now = time.perf_counter()
            if stack:
                top = stack[-1]
                totals[top[0]] += now - top[1]
            stack.append([cat, now])
            try:
                return fn(*args, **kwargs)
            finally:
                now = time.perf_counter()
                c, t0 = stack.pop()
                totals[c] += now - t0
                if stack:
                    stack[-1][1] = now
        return wrapper

    prop = sprop.ShardingPropagator
    for name in ("propagate", "propagate_op_sharding_non_cached"):
        setattr(prop, name, timed("prop", getattr(prop, name)))
    cache = sprop.LocalLRUCache
    cache.__call__ = timed("prop", cache.__call__)
    slow = "_propagate_op_sharding_dispatch_slow_path"
    if hasattr(dispatch.OpDispatcher, slow):
        setattr(dispatch.OpDispatcher, slow,
                timed("prop", getattr(dispatch.OpDispatcher, slow)))
    fn = timed("redistribute", redist.redistribute_local_tensor)
    for mod in (redist, dispatch, api):
        if hasattr(mod, "redistribute_local_tensor"):
            mod.redistribute_local_tensor = fn
    D.StepCounter.__torch_dispatch__ = timed(
        "counter", D.StepCounter.__torch_dispatch__)


def one(arch, shape, mesh, layers, timeout, cprofile) -> dict:
    """The split of one traced cell (this process)."""
    from repro_torch.launch import dryrun as D
    totals = dict.fromkeys(CATS, 0.0)
    _instrument(totals)

    def stop(*_):
        raise _Stop()
    signal.signal(signal.SIGALRM, stop)
    prof = None
    if cprofile:
        import cProfile
        prof = cProfile.Profile()
    status = "ok"
    t0 = time.perf_counter()
    signal.alarm(timeout)
    try:
        if prof:
            prof.enable()
        D.run_cell(arch, shape, mesh, save=False,
                   cfg_overrides={"num_layers": layers})
    except _Stop:
        status = f"stopped at {timeout} s"
    except Exception as e:  # noqa: BLE001
        status = f"{type(e).__name__}: {e}"[:300]
    finally:
        if prof:
            prof.disable()
        signal.alarm(0)
    wall = time.perf_counter() - t0
    if prof:
        import io
        import pstats
        s = io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(60)
        with open(cprofile, "w") as f:
            f.write(s.getvalue())
    out = {"arch": arch, "shape": shape, "mesh": mesh, "layers": layers,
           "status": status, "wall_s": wall, **totals}
    out["other"] = wall - sum(totals.values())
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--timeout", type=int, default=300)
    ap.add_argument("--cprofile", default="")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("SPLIT " + json.dumps(one(args.arch, args.shape, args.mesh,
                                        args.layers[0], args.timeout,
                                        args.cprofile)), flush=True)
        return
    runs = []
    todo = [(n, "") for n in args.layers]
    if args.cprofile:
        todo.append((args.layers[0], args.cprofile))
    for n, cprofile in todo:
        cmd = [sys.executable, __file__, "--one", "--arch", args.arch,
               "--shape", args.shape, "--mesh", args.mesh, "--layers",
               str(n), "--timeout", str(args.timeout)]
        if cprofile:
            cmd += ["--cprofile", cprofile]
        res = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("SPLIT ")]
        if not lines:
            raise SystemExit(f"layers {n}: exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
        r = json.loads(lines[-1][len("SPLIT "):])
        if cprofile:
            print(f"layers={n} under cProfile: {r['status']}, wall "
                  f"{r['wall_s']:.1f} s -> {cprofile}", flush=True)
            continue
        runs.append(r)
        print(f"{args.arch} {args.shape} {args.mesh} layers={n} "
              f"{r['status']}: wall {r['wall_s']:.1f} s, " + ", ".join(
                  f"{c} {r[c]:.1f}" for c in CATS + ("other",)), flush=True)
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
