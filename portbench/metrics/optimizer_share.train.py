"""Optimizer (`optim/adamw.py`): the seconds inside the program's
`train.optimizer` spans (AdamW, its global-norm clip included), over the
window."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    return _program.share(run, "train.optimizer")
