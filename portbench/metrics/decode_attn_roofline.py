"""Kernels (`kernels/decode_attention`): the decode kernel's least time
(the valid cache slots' bytes read once) over its device time in the
trace, in percent."""
from pathlib import Path

from portbench import bench

ROOFLINES = ["decode_attention"]
_share = bench.load_file(Path(__file__).with_name("_roofline.py"),
                         "portbench_metric__roofline")


def read(run):
    return _share.share(run, "decode_attention")
