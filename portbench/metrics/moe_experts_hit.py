"""Model (`models/layers.py`): the share of the experts that a decode
step's MoE layer routes a kept choice to, the mean over the
`model.moe.route` spans inside `serve.decode_step` spans of the
program's `moe.experts_hit` counter over the span's `experts`. The
expert FFNs compute and read every expert all the same."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    routes = [r for r in _program.under(run, "model.moe.route",
                                        "serve.decode_step")
              if "moe.experts_hit" in r["counts"]]
    if not routes:
        return None
    return sum(r["counts"]["moe.experts_hit"] / r["attrs"]["experts"]
               for r in routes) / len(routes)
