"""Model (`models/layers.py`): the seconds inside the program's
`model.mamba2.scan` spans (the chunked SSD scan of a prefill, the
recurrence's one step at decode), over the window."""
from pathlib import Path

from portbench import bench

_program = bench.load_file(Path(__file__).with_name("_program.py"),
                           "portbench_metric__program")


def read(run):
    return _program.share(run, "model.mamba2.scan")
