#!/usr/bin/env python3
"""A rank's share of each smoke variant's step on fake meshes.

    PYTHONPATH=src python3 tools/dryrun_shares.py [--archs A,B] \
        [--kinds train,prefill,decode] [--meshes 2x2,2x4]

For each arch's smoke variant (batch 8, seq 16) and step kind, traces the
world-1 step and the step on each fake ("data", "model") mesh with
`repro_torch.launch.dryrun.trace_cell`, and prints one line: the world-1
FLOPs, and on each mesh a rank's FLOPs times the mesh size over the
world-1 FLOPs (1.0: no rank repeats another's work; heads are padded on
the mesh only, as the reference pads them) and a rank's collective (ICI)
bytes. The last line is one JSON object of them all.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    from repro_torch.configs import ALL_ARCHS, get_config, smoke_variant
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import MeshDesc
    from repro_torch.optim import OptimizerConfig
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(ALL_ARCHS))
    ap.add_argument("--kinds", default="train,prefill,decode")
    ap.add_argument("--meshes", default="2x2,2x4")
    args = ap.parse_args()
    oc = OptimizerConfig()
    out = []
    for arch in args.archs.split(","):
        cfg = smoke_variant(get_config(arch))
        for kind in args.kinds.split(","):
            shape = ShapeConfig("smoke", 16, 8, kind)
            w1 = D.trace_cell(cfg, shape, None, opt_cfg=oc).flops
            row = {"arch": arch, "kind": kind, "world1_flops": w1}
            for m in args.meshes.split(","):
                sizes = tuple(int(n) for n in m.split("x"))
                try:
                    c = D.trace_cell(cfg, shape,
                                     MeshDesc(("data", "model"), sizes),
                                     opt_cfg=oc)
                    row[m] = {"ratio": c.flops * math.prod(sizes) / w1,
                              "ici_bytes": c.ici_bytes}
                except Exception as e:  # noqa: BLE001
                    row[m] = {"error": f"{type(e).__name__}: {e}"[:200]}
            out.append(row)
            print(f"{arch:24s} {kind:8s} world-1 {w1:.4e} | " + " | ".join(
                f"{m}: " + (f"{row[m]['ratio']:.4f}, ICI "
                            f"{row[m]['ici_bytes']:.4e} B"
                            if "ratio" in row[m] else row[m]["error"])
                for m in args.meshes.split(",")), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
