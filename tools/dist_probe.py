#!/usr/bin/env python3
"""Probe the int8 cross-pod sync at h2o-danube-1.8b's full width on a card.

    python3 tools/dist_probe.py [--seeds 0 1 2 3]

Run from the root of a checkout on a machine with one NVIDIA card and nvcc.
It opens a world-1 NCCL group, as phase `distributed` of chip_smoke.py
does, and trains h2o-danube-1.8b whole (24 layers, bf16, batch 4 x 2048,
3 steps) through that phase's `_dist_run`. Three readings:

1. gap -- for each seed, the compressed_pod run on a (1, 1, 1) mesh
   against gspmd on a (1, 1) mesh at the reference's test optimizer (lr
   1e-3, warmup 100): the largest |loss difference| over the steps, the
   number chip_smoke.py gates at COMPRESSED_TOL.
2. zeros -- on the largest gradient leaves, the share of entries that
   quantized_psum_pod sends as 0 (round((g + ef) / scale) = 0, one scale
   for the whole stacked leaf) and the share of the leaf's squared norm
   that they hold (left to the error feedback): at the first step (ef 0)
   and at the compressed run's last batch with its ef; beside each, the
   same share had every layer of the stacked leaf its own scale.
3. schedule -- at train_loop's schedule (lr 3e-4, warmup 10: steps of lr
   3e-5, 6e-5, 9e-5), the meshless kernel path, the meshless plain path
   (no kernel: a second witness), the compressed run on (1, 1, 1), and the
   kernel path at lr 0 and at a tenth of the lr; each loss over the lr-0
   loss on its batch.

Each reading prints a line; the last line is one JSON object of them all.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LEAVES = 4      # largest gradient leaves read by `zeros`


def _zero_shares(torch, g, ef, o) -> dict:
    """The share of entries sent as 0 (`o`, the sync's output, is 0 there)
    and the share of |g + ef|^2 they hold; then the same share of entries
    with one scale per layer (the leaf's first dim)."""
    val = g.float() + ef.float()
    sq = val.square()
    zero = o == 0
    amax = val.abs().flatten(1).amax(1).view(-1, *[1] * (val.ndim - 1))
    per_layer = torch.round(val / torch.clamp(amax / 127.0, min=1e-12)) == 0
    return {"zero_share": float(zero.float().mean()),
            "norm_share": float((sq * zero).sum() / sq.sum()),
            "zero_share_per_layer_scale": float(per_layer.float().mean())}


def _zeros(torch, cfg, params, ef, batch, mesh3) -> dict:
    """`_zero_shares` on the LEAVES largest gradient leaves of `params` on
    `batch`, with `ef` (a tree like the params, or None for zeros)."""
    from repro_torch.core.collectives import quantized_psum_pod
    from repro_torch.core.streaming_checkpoint import _leaf_paths
    from repro_torch.train.steps import make_grad_fn
    _, grads = make_grad_fn(cfg)(params, batch)
    leaves = list(_leaf_paths(grads))
    efs = None if ef is None else dict(_leaf_paths(ef))
    out = {}
    for path, g in sorted(leaves, key=lambda pl: -pl[1].numel())[:LEAVES]:
        e = torch.zeros_like(g) if efs is None else efs[path]
        o, _ = quantized_psum_pod(g, e, mesh3)
        out[path] = {"shape": list(g.shape), **_zero_shares(torch, g, e, o)}
        del o, e
    del grads
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.optim import OptimizerConfig
    card = cs.phase_card(torch)
    root = ROOT / "build" / "dist_probe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(root / "store"), 1), rank=0, world_size=1)
    B, S, steps = cs.DIST
    cfg = cs._h2o()
    result = {"card": card, "shape": [B, S, steps]}
    try:
        mesh2 = make_host_mesh(1, 1)
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))

        # 1. the gated gap, seed by seed
        gaps = {}
        for seed in args.seeds:
            batches = [cs._device_batch(torch, cfg, B, S, i, seed)
                       for i in range(steps)]
            runs = {sync: cs._dist_run(torch, cfg, seed, batches, mesh, sync)
                    ["losses"] for sync, mesh in (("gspmd", mesh2),
                                                  ("compressed_pod", mesh3))}
            gap = max(abs(a - b) for a, b in zip(runs["gspmd"],
                                                 runs["compressed_pod"]))
            gaps[seed] = {**runs, "gap": gap}
            print(f"gap seed {seed}: gspmd {runs['gspmd']}, compressed "
                  f"{runs['compressed_pod']}: {gap!r} (gate "
                  f"{cs.COMPRESSED_TOL}) on {card}", flush=True)
        result["gap"] = gaps

        # 2. entries sent as 0: the first step, then with a run's ef
        seed = args.seeds[0]
        batches = [cs._device_batch(torch, cfg, B, S, i, seed)
                   for i in range(steps)]
        run = cs._dist_run(torch, cfg, seed, batches, mesh3,
                           "compressed_pod", keep=True)
        state = run.pop("state")
        from repro_torch.models import model as M
        params = M.init_params(torch.Generator(cs.DEVICE).manual_seed(seed),
                               cfg)
        first = _zeros(torch, cfg, params, None, batches[0], mesh3)
        del params
        last = _zeros(torch, cfg, cs._local(state.params),
                      cs._local(state.ef), batches[-1], mesh3)
        del state, run
        torch.cuda.empty_cache()
        result["zeros"] = {"first_step": first, "after_steps": last}
        for name, z in (("first step, ef 0", first),
                        (f"after {steps} compressed steps, with their ef",
                         last)):
            print(f"zeros, {name}: {json.dumps(z)}", flush=True)

        # 3. train_loop's schedule: two witnesses, lr 0 and a tenth
        sched = {}
        for name, lr, mesh, sync, kern in (
                ("kernel path", 3e-4, None, "gspmd", True),
                ("plain path", 3e-4, None, "gspmd", False),
                ("compressed_pod (1, 1, 1)", 3e-4, mesh3, "compressed_pod",
                 True),
                ("kernel path lr 0", 0.0, None, "gspmd", True),
                ("kernel path lr 3e-5", 3e-5, None, "gspmd", True)):
            oc = OptimizerConfig(lr=lr, warmup=10, total_steps=steps)
            sched[name] = cs._dist_run(torch, cfg, seed, batches, mesh, sync,
                                       oc=oc, use_kernels=kern)["losses"]
        base = sched["kernel path lr 0"]
        ratios = {name: [a / b for a, b in zip(losses, base)]
                  for name, losses in sched.items()}
        result["schedule"] = {"losses": sched, "over_lr0": ratios}
        for name, losses in sched.items():
            print(f"schedule, {name}: losses {losses}, over lr 0 "
                  f"{ratios[name]}", flush=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
