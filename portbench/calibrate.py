"""Readings that set a cell's limits, on the card, many seeds in one
process (the benchmark's runs never run this):

- `program`: the numbers that a sound run of the program gives;
- `control`: the same numbers with the reference computed in fp8 (its
  matrix products' operands rounded to float8 e4m3) in the program's
  place: for serving, the gaps of the tokens that the fp8 reference
  puts first; for training, its losses, gradients and changes;
- `fault:<name>`: the numbers with a fault of `faults.py` planted in
  the program (training: `half`, a step over half of the batch;
  `no_writeback`, a step that leaves the working weights unchanged);
- `witness:route_bf16` (serving): the float32 reference with only its
  MoE router's input rounded to bf16, in the program's place.

    python3 portbench/calibrate.py --workload CELL --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half] [--fault-seeds 1,2,3] \
        [--witness-seeds 1,2,3]

Serving cells serve `check_batches` batches a seed and compare them all,
as a run compares that many of its window's. One JSON line a reading on
standard output.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench import bench  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def _free():
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_seed(cell, seed, control, faults, witness=False):
    from portbench import faults as F
    from portbench import generate
    drv = cell.driver()
    ref, m, tr, dev = cell.reference, cell.model, cell.traffic, cell.device
    first = tr["first_steps"]
    batches = generate.train_batches(tr, m["vocab_size"], seed, dev)[:first]
    out = []
    params = ref.make_params(m, seed, dev)
    state, step, prog = drv.first_steps(cell, params, batches)
    del state, step, params
    _free()
    readings = {}
    for name in faults:
        params = ref.make_params(m, seed, dev)
        with F.FAULTS["train"][name]():
            state, step, readings[name] = drv.first_steps(cell, params,
                                                          batches)
        del state, step, params
        _free()
    params = ref.make_params(m, seed, dev)
    refr = drv.reference_readings(cell, params, batches)

    def row(name, got):
        return (name, drv.compare(got, refr, tr.get("loss_steps")),
                got["loss"], refr["loss"])
    out.append(row("program", prog))
    for name, r in readings.items():
        out.append(row(f"fault:{name}", r))
    if control:
        out.append(row("control", drv.reference_readings(
            cell, params, batches, quant="fp8")))
    return [{"reading": k, "numbers": n, "losses": lp, "ref_losses": lr}
            for k, n, lp, lr in out]


def _spread(g):
    """Quantiles of the served tokens' gaps, and each request's widest."""
    import torch
    flat = torch.cat([x.flatten() for x in g]).float().cpu()
    qs = torch.quantile(flat, torch.tensor([0.5, 0.75, 0.9, 0.95, 0.99]))
    return {"gap_q50_75_90_95_99": [float(v) for v in qs],
            "request_max": [round(float(v), 4) for x in g
                            for v in x.amax(-1)]}


def serve_seed(cell, seed, control, faults, witness=False):
    from portbench import faults as F
    from portbench import generate
    drv = cell.driver()
    ref, m, tr, dev = cell.reference, cell.model, cell.traffic, cell.device
    params = ref.make_params(m, seed, dev)
    pool = generate.prompt_batches(tr, m["vocab_size"], seed, dev)
    n = tr["check_batches"]
    out = []
    done = drv.serve_batches(cell, params, pool, count=n)
    _free()
    g = drv.gaps(cell, params, pool, done, range(n))
    out.append({"reading": "program", "numbers": drv.numbers(g),
                **_spread(g)})
    for name in faults:
        with F.FAULTS["serve"][name]():
            bad = drv.serve_batches(cell, params, pool, count=n)
        g = drv.gaps(cell, params, pool, bad, range(n))
        out.append({"reading": f"fault:{name}", "numbers": drv.numbers(g)})
    if control:
        g = drv.gaps(cell, params, pool, done, range(n), quant="fp8")
        out.append({"reading": "control", "numbers": drv.numbers(g),
                    **_spread(g)})
    if witness:
        g = drv.gaps(cell, params, pool, done, range(n), quant="route_bf16")
        out.append({"reading": "witness:route_bf16",
                    "numbers": drv.numbers(g), **_spread(g)})
    return out


def main():
    import argparse
    import json

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--witness-seeds", type=_ints, default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    faults = [f for f in args.faults.split(",") if f]
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds
                               + args.fault_seeds + args.witness_seeds))
    for seed in seeds:
        cell = bench.Cell(ROOT, args.workload, seed, 0.0, False,
                          device=torch.device("cuda", 0))
        fn = train_seed if cell.traffic["kind"] == "train" else serve_seed
        t0 = time.perf_counter()
        rows = fn(cell, seed, seed in args.control_seeds,
                  faults if seed in args.fault_seeds else [],
                  seed in args.witness_seeds)
        for r in rows:
            if r["reading"] == "program" and seed not in args.seeds:
                continue
            r.update(workload=args.workload, seed=seed,
                     seconds=time.perf_counter() - t0)
            print(json.dumps(r), flush=True)
        _free()
    print(f"calibrate: forbidden modules {bench.forbidden_modules()}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    bench.cache_env(ROOT)
    sys.exit(main())
