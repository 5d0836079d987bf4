#!/usr/bin/env python3
"""Which water-fill components a simulator run hands the jit solver, and
what the port's solver takes on them against numpy's.

    PYTHONPATH=src python3 tools/waterfill_components.py [--device cuda|cpu]
        [--nodes 256] [--rack 16] [--waves 2] [--sample 200] [--reps 3]

Runs the reference simulator's jit-solver scenario of
`benchmarks/bench_sim.py` (`scenario_engine_xscale`'s jit anchor:
`lovelock_cluster` of `--nodes` nodes, racks of `--rack`, a 2:1 fabric,
`pipelined_shuffle_waves` with 2 tasks a node, jitter 0.35, seed 7; its
deferred batches, failure and callbacks left out) on the array backend
with `solver="jit"`. The array core hands the jit solver every component
of at least 192 flows; here a recorder stands in for it, keeps each
component's CSR arrays and solves it with the numpy allocator, so the
run's trace is the numpy run's.

Then `--sample` of the recorded components, evenly spaced in the run, are
each solved `--reps` times by the port's numpy copy and by
`vector_water_fill_torch` on `--device`; every result on the device must
be bitwise numpy's. Prints one JSON line: the number of components, their
flow counts (min, median, max, and a histogram by powers of two), and
each solver's mean milliseconds a component over the sample (the fastest
of the reps for each). Imports `repro.sim`, which does not
import jax, and `repro_torch`; run it where both are on the path.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def record_components(nodes: int, rack: int, waves: int) -> list:
    """The (indptr, indices, cap) of every component the array core routes
    to the jit solver in the scenario."""
    import repro.sim.alloc as ralloc
    from repro.sim import Fabric, lovelock_cluster, pipelined_shuffle_waves

    seen = []

    def recorder(indptr, indices, cap):
        seen.append((indptr.copy(), indices.copy(), cap.copy()))
        return ralloc.vector_water_fill(indptr, indices, cap)

    ralloc.vector_water_fill_jit = recorder
    topo = lovelock_cluster(nodes, 1, fabric=Fabric(rack_size=rack,
                                                    oversubscription=2.0))
    tasks = list(pipelined_shuffle_waves(topo, waves=waves, tasks_per_node=2,
                                         jitter=0.35, seed=7))
    res = topo.engine(backend="array", solver="jit").run(tasks)
    if not res.complete:
        raise SystemExit("the scenario did not complete")
    return seen


def best_ms(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--rack", type=int, default=16)
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--sample", type=int, default=200)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.sim.alloc import vector_water_fill, vector_water_fill_torch

    t0 = time.perf_counter()
    comps = record_components(args.nodes, args.rack, args.waves)
    run_s = time.perf_counter() - t0
    flows = np.array([c[0].size - 1 for c in comps], dtype=np.int64)
    if not comps:
        print(json.dumps({"components": 0, "run_s": run_s}))
        return 0
    vector_water_fill_torch(*comps[0], device=args.device)      # warm up
    pick = np.unique(np.linspace(0, len(comps) - 1, min(args.sample,
                                                          len(comps)))
                     .round().astype(np.int64))
    np_ms = card_ms = 0.0
    for i in pick:
        indptr, indices, cap = comps[i]
        want = vector_water_fill(indptr, indices, cap.copy())
        got = vector_water_fill_torch(indptr, indices, cap.copy(),
                                      device=args.device)
        if got.tobytes() != want.tobytes():
            raise SystemExit(f"{indptr.size - 1} flows: the port's solver "
                             "differs from numpy")
        np_ms += best_ms(lambda: vector_water_fill(indptr, indices,
                                                   cap.copy()), args.reps)
        card_ms += best_ms(lambda: vector_water_fill_torch(
            indptr, indices, cap.copy(), device=args.device), args.reps)
    hist = {}
    for n in flows:
        b = 1 << (int(n) - 1).bit_length()
        hist[b] = hist.get(b, 0) + 1
    dev = torch.device(args.device)
    print(json.dumps({
        "scenario": {"nodes": args.nodes, "rack": args.rack,
                     "waves": args.waves, "run_s": run_s},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "components": len(comps),
        "flows": {"min": int(flows.min()), "median": float(np.median(flows)),
                  "max": int(flows.max()),
                  "up_to_pow2": {str(k): v for k, v in sorted(hist.items())}},
        "sample": int(pick.size), "numpy_ms_mean": np_ms / pick.size,
        "port_ms_mean": card_ms / pick.size, "bitwise_equal": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
