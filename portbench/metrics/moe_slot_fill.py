"""Model (`models/layers.py`): the share of the MoE's expert slots (E x
C a layer) that hold a kept choice, over the routes of the window's
prefills: the program's `moe.kept` over its `moe.slots` counters, summed
over the `model.moe.route` spans inside `serve.prefill` spans."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    routes = _program.under(run, "model.moe.route", "serve.prefill")
    slots = sum(r["counts"].get("moe.slots", 0) for r in routes)
    if not slots:
        return None
    return sum(r["counts"].get("moe.kept", 0) for r in routes) / slots
