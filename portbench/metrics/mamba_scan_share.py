"""Model (`models/layers.py`): the seconds inside the program's
`model.mamba.scan` spans (the chunked selective scan alone, without the
Mamba block's projections and conv), over the window."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    return _program.share(run, "model.mamba.scan")
