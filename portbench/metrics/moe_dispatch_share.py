"""Model (`models/layers.py`): the MoE's self time, the seconds inside
the program's `model.moe` spans less those of their child spans (the
routing, `model.moe.route`, and the expert FFNs, `model.moe.experts`):
the dispatch into the experts' slots and the combine back, over the
window."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    recs = _program.records(run)
    moe = {r["id"]: _program.seconds(run, r) for r in recs
           if r["name"] == "model.moe"}
    if not moe:
        return None
    for r in recs:
        if r["parent"] in moe:
            moe[r["parent"]] -= _program.seconds(run, r)
    return sum(moe.values()) / run.window_s
