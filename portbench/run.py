"""Benchmark of the PyTorch / CUDA port (`repro_torch`) on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Runs one cell of BENCHMARK.json: makes
its weights and traffic from the seed on the card, warms up its shapes,
measures whole steps or batches for the given seconds, then compares
what the window produced with the plain float32 reference under
portbench/reference/. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, [breakdown],
diagnostics, checks); the numbers compared, each with its limit, are
the last lines of standard error. With --trace 1 the metrics are the
cell's per-layer metrics, read from torch.profiler and CUDA events over
the window.
Exits 2 without a result where there is no card, too few cards, no
program under test, or a loaded module of jax or the JAX package.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and src/ in place of this file's directory, whose
# module names would shadow others
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench import bench  # noqa: E402

if __name__ == "__main__":
    bench.cache_env(ROOT)
    sys.exit(bench.main(t_start=T_START))
