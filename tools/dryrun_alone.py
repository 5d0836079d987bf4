#!/usr/bin/env python3
"""Whether a dry-run cell traced alone gives the record `--all` saved.

    PYTHONPATH=src python3 tools/dryrun_alone.py jamba-v0.1-52b:prefill_32k:single ...

Each named arch:shape:mesh cell is traced by `run_cell` (not saved) in a
fresh process and compared, key by key, with its record under
artifacts/dryrun_torch/ (written by `python -m repro_torch.launch.dryrun
--all --mesh both`, where every cell follows the ones before it in one
process). `lower_s` (the trace's seconds) is left out. Prints one line a
cell, "same" or the keys that differ, and exits 1 if any differs.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_ONE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.launch.dryrun import run_cell
print("RECORD " + json.dumps(run_cell(*sys.argv[1].split(":"), save=False)))
"""


def main() -> int:
    bad = 0
    for cell in sys.argv[1:]:
        saved = json.loads((ROOT / "artifacts" / "dryrun_torch" /
                            f"{cell.replace(':', '__')}.json").read_text())
        res = subprocess.run(
            [sys.executable, "-c", _ONE.format(src=str(ROOT / "src")), cell],
            capture_output=True, text=True, check=True)
        alone = json.loads([ln for ln in res.stdout.splitlines()
                            if ln.startswith("RECORD ")][-1][len("RECORD "):])
        diff = sorted(k for k in set(saved) | set(alone)
                      if k != "lower_s" and saved.get(k) != alone.get(k))
        bad += bool(diff)
        print(f"{cell}: {'same' if not diff else 'differs in ' + ', '.join(diff)}"
              f" (lower_s {saved['lower_s']} in --all, {alone['lower_s']} "
              "alone)", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
