#!/usr/bin/env python3
"""The dry-run's records as one markdown table, a row per (arch, shape).

    python3 tools/dryrun_table.py [artifacts/dryrun_torch]

Reads the records `python -m repro_torch.launch.dryrun --all --mesh both`
writes, and prints, for each arch and shape in `ALL_ARCHS` x `SHAPES`
order, the single-pod and multi-pod cells side by side: trace seconds
(`lower_s`), FLOPs a device, model FLOPs over traced FLOPs, ICI and DCN
bytes a device, and the roofline's bottleneck. A skipped cell (the
reference's `supports_shape`) has no record and no row. The last line
counts the cells and names the torch versions the records were traced
on.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ALL_ARCHS, SHAPES  # noqa: E402


def _pair(recs, fmt) -> str:
    """fmt of the single-pod and the multi-pod record, "-" for a missing
    one."""
    return " / ".join(fmt(r) if r else "-" for r in recs)


def row(arch, shape, recs) -> str:
    """The table's row for one (arch, shape): recs, the single-pod and
    multi-pod records (None where missing)."""
    dcn = recs[1]["collectives"]["dcn_bytes"] if recs[1] else None
    cells = [
        arch, shape,
        _pair(recs, lambda r: f"{r['lower_s']}"),
        _pair(recs, lambda r: f"{r['roofline']['flops']:.3e}"),
        _pair(recs, lambda r: f"{r['roofline']['useful_ratio']:.4f}"),
        _pair(recs, lambda r: f"{r['collectives']['ici_bytes']:.3e}"),
        "-" if dcn is None else f"{dcn:.3e}",
        _pair(recs, lambda r: r["roofline"]["bottleneck"])]
    return "| " + " | ".join(cells) + " |"


def main() -> None:
    art = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "artifacts" / "dryrun_torch"
    print("| arch | shape | lower_s s / m | FLOPs a device s / m | model / "
          "traced s / m | ICI bytes s / m | DCN bytes m | bottleneck s / m |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    n, torches = 0, set()
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            recs = []
            for mesh in ("single", "multi"):
                f = art / f"{arch}__{shape}__{mesh}.json"
                recs.append(json.loads(f.read_text()) if f.exists()
                            else None)
            if any(recs):
                n += sum(r is not None for r in recs)
                torches |= {r["torch"] for r in recs if r}
                print(row(arch, shape, recs))
    print(f"\n{n} records; torch {', '.join(sorted(torches))}")


if __name__ == "__main__":
    main()
