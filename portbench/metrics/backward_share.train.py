"""Train step (`train/steps.py`, `optim/`): the seconds inside the
program's `train.backward` spans (the loss's gradient, with the remat
recompute of the forward), over the window."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    return _program.share(run, "train.backward")
