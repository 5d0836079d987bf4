"""Kernels (`kernels/flash_attention`): the flash forward's least time
(operations and bytes from each call's shapes) over its device time in
the trace, in percent."""
from pathlib import Path

from portbench import bench

ROOFLINES = ["flash_attention"]
_share = bench.load_file(Path(__file__).with_name("_roofline.py"),
                         "portbench_metric__roofline")


def read(run):
    return _share.share(run, "flash_attention")
