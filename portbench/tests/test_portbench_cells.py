"""Every cell kind driven end to end on the CPU at a small size through
the program's plain paths, with the look for a card skipped: a sound run
is correct and ends in one valid result line; with a fault planted
under the timed path, or the fp8 control in the program's place, it is
not."""
import contextlib
import io
import json

import pytest
import torch

from conftest import CELLS
from portbench import bench, faults

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, seed, trace=False, fault=None, seconds=0.5):
    c = bench.Cell(root, cell, seed, seconds, trace,
                   device=torch.device("cpu"))
    ctx = (faults.FAULTS[c.traffic["kind"]][fault]() if fault
           else contextlib.nullcontext())
    out, err = io.StringIO(), io.StringIO()
    with ctx, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        bench.emit(bench.execute(c, 0.0))
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    return c, last, err.getvalue().strip().splitlines()


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_sound_run_is_correct(tiny_root, cell, trace):
    c, last, err = _run(tiny_root, cell, 21, trace)
    assert list(last)[:5] == KEYS and list(last)[-1] == "checks"
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] > 0 and last["failed"] == 0
    names = {m["name"] for m in (c.per_layer if trace else c.e2e)}
    # readers that find no device work in a CPU run report nothing
    assert set(last["metrics"]) <= names
    if not trace:
        assert set(last["metrics"]) == names
        assert "setup_s" in last["metrics"]
    else:
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, chk in last["checks"].items():
        assert err[-len(last["checks"]):].count(
            f"check {name} = {chk['value']!r} (limit {chk['limit']!r})") == 1


def test_added_metric_is_read(tiny_root):
    _, last, _ = _run(tiny_root, "tiny-serve", 22, trace=True)
    assert last["metrics"]["probe_batches"]["value"] >= 1


@pytest.mark.parametrize("cell,fault", [
    ("tiny-train", "frozen"), ("tiny-train", "half"),
    ("tiny-train", "no_writeback"),
    ("tiny-serve", "frozen"), ("tiny-serve", "token"),
    ("tiny-hy-serve", "frozen"), ("tiny-hy-serve", "token")])
def test_fault_is_caught(tiny_root, cell, fault):
    _, last, _ = _run(tiny_root, cell, 23, fault=fault)
    assert last["correct"] is False, last["checks"]


def test_control_reads_above_the_program_train():
    """The fp8 control in the program's place reads above the bf16
    program at the same seeds (at this size the two are close; the
    limits are set from the cells' own sizes on the card)."""
    from portbench import generate
    from portbench.reference import decoder
    from conftest import DENSE
    drv = bench.load_file(bench.HERE / "drivers" / "train.py", "drv_c")
    cell = bench.Cell.__new__(bench.Cell)
    cell.model, cell.reference = DENSE, decoder
    cell.traffic = CELLS["tiny-train"][1]
    worse = 0
    for seed in (1, 2, 3):
        batches = generate.train_batches(cell.traffic, 256, seed, "cpu")[:3]
        params = decoder.make_params(DENSE, seed, "cpu")
        _, _, prog = drv.first_steps(cell, params, batches)
        refr = drv.reference_readings(
            cell, decoder.make_params(DENSE, seed, "cpu"), batches)
        low = drv.reference_readings(
            cell, decoder.make_params(DENSE, seed, "cpu"), batches,
            quant="fp8")
        p, q = drv.compare(prog, refr), drv.compare(low, refr)
        worse += q["grad_norm"] > p["grad_norm"]
    assert worse == 3


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-hy-serve"])
def test_control_reads_above_the_program_serve(tiny_root, cell):
    """The tokens the fp8 control puts first sit farther below the
    reference's best than the program's, over the same batches."""
    from portbench import generate
    c = bench.Cell(tiny_root, cell, 0, 0.0, False,
                   device=torch.device("cpu"))
    drv = c.driver()
    worse = 0
    for seed in (1, 2, 3):
        params = c.reference.make_params(c.model, seed, "cpu")
        pool = generate.prompt_batches(c.traffic, c.model["vocab_size"],
                                       seed, "cpu")
        done = drv.serve_batches(c, params, pool, count=2)
        prog = drv.numbers(drv.gaps(c, params, pool, done, [0, 1]))
        low = drv.numbers(drv.gaps(c, params, pool, done, [0, 1],
                                   quant="fp8"))
        worse += low["gap"] > prog["gap"]
    assert worse == 3


def _cells():
    from conftest import ROOT
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_the_cell_on_the_card(cell):
    """At the cell's own size on the card, the fp8 control in the
    program's place fails one of the cell's compared numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util
    from conftest import ROOT
    spec = importlib.util.spec_from_file_location(
        "portbench_calibrate", ROOT / "portbench" / "calibrate.py")
    cal = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cal)
    c = bench.Cell(ROOT, cell, 5, 0.0, False, device=torch.device("cuda", 0))
    fn = cal.train_seed if c.traffic["kind"] == "train" else cal.serve_seed
    rows = {r["reading"]: r["numbers"] for r in fn(c, 5, True, [])}
    lim = c.limits["limits"]
    assert all(rows["program"][k] <= v for k, v in lim.items())
    assert any(rows["control"][k] > v for k, v in lim.items())
