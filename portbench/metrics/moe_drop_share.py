"""Model (`models/layers.py`): the share of the MoE's expert choices
that its capacity drops, 1 - the program's `moe.kept` over its
`moe.choices` counters (N x K a whole-batch route), summed over the
window's routes, prefills and decode steps alike. Nothing over a program
without the `moe.choices` counter."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    routes = [r for r in _program.records(run)
              if "moe.choices" in r["counts"]]
    choices = sum(r["counts"]["moe.choices"] for r in routes)
    if not choices:
        return None
    return 1.0 - sum(r["counts"].get("moe.kept", 0) for r in routes) / choices
