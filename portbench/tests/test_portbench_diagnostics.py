"""Each run's diagnostics on the CPU: the result line carries them
beside the metrics, which keep their names; a CPU run reads "not
measured" for every field of the card and its allocator; the series
summaries; and the draw of the checked batches."""
import contextlib
import io
import json

import pytest
import torch

from portbench import bench, diagnostics

NOT = diagnostics.NOT
# the metrics a CPU run of each tiny cell reports, as before the
# diagnostics
METRICS = {
    ("tiny-train", False): {"train_tokens_per_s", "setup_s"},
    ("tiny-serve", False): {"serve_tokens_per_s", "request_p95_ms",
                            "setup_s"},
    ("tiny-train", True): {"mfu.train", "backward_share.train",
                           "optimizer_share.train"},
    # the cell's span and device readers find nothing to read on the CPU
    ("tiny-serve", True): {"decode_step_ms", "prefill_tokens_per_s",
                           "mfu.serve", "probe_batches"},
}
SERIES = {"tiny-train": {"step_s"},
          "tiny-serve": {"batch_s", "prefill_s", "decode_s"}}


def _run(root, cell, seed, trace):
    c = bench.Cell(root, cell, seed, 0.5, trace, device=torch.device("cpu"))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        bench.emit(bench.execute(c, 0.0))
    return (json.loads(out.getvalue().strip().splitlines()[-1]),
            err.getvalue().strip().splitlines())


@pytest.mark.parametrize("cell,trace", sorted(METRICS),
                         ids=[f"{c}-trace{int(t)}" for c, t in
                              sorted(METRICS)])
def test_result_line_carries_diagnostics(tiny_root, cell, trace):
    last, err = _run(tiny_root, cell, 31, trace)
    assert list(last)[-2:] == ["diagnostics", "checks"]
    assert set(last["metrics"]) == METRICS[cell, trace]
    d = last["diagnostics"]
    assert set(d) == SERIES[cell] | {"host", "allocator", "card"}
    for k in SERIES[cell]:
        s = d[k]
        assert s["n"] == last["attempted"] // (
            1 if cell == "tiny-train" else 3)
        assert s["min"] <= s["median"] <= s["max"] and s["min"] >= 0
    assert d["card"] == {"sm_clock_mhz": NOT, "power_w": NOT, "samples": 0}
    assert set(d["allocator"].values()) == {NOT}
    h = d["host"]
    assert len(h["loadavg_before"]) == len(h["loadavg_after"]) == 3
    assert 1 <= h["affinity_cpus"] <= h["cpu_count"]
    assert h["process_cpu_share"] > 0 and h["gc_s"] >= 0
    # the raw series come on standard error, before the compared numbers
    series = [x for x in err if x.startswith("portbench: series ")]
    assert len(series) == 1
    raw = json.loads(series[0][len("portbench: series "):])
    assert set(raw) == SERIES[cell] | {"card"} and raw["card"] == []
    assert err[-1].startswith("check ")


def test_summary():
    s = diagnostics.summary([3.0, 1.0, 2.0, 10.0, 4.0])
    assert s == {"n": 5, "median": 3.0, "min": 1.0, "max": 10.0,
                 "first3_mean": 2.0, "rest_mean": 7.0}
    assert diagnostics.summary([1.0, 2.0])["rest_mean"] == NOT
    assert diagnostics.summary([]) == NOT


@pytest.mark.parametrize("check,batches", [(8, 44), (8, 5), (4, 30),
                                           (1, 1)])
def test_picks_are_distinct_and_sorted(check, batches):
    from conftest import ROOT
    drv = bench.load_file(ROOT / "portbench/drivers/serve.py", "drv_p")
    cell = bench.Cell.__new__(bench.Cell)
    cell.traffic = {"check_batches": check}
    for seed in (0, 7, 2**31 + 5):
        cell.seed = seed
        got = drv.picks(cell, batches)
        assert len(got) == min(check, batches) == len(set(got))
        assert got == sorted(got)
        assert all(0 <= i < batches for i in got)
        assert got == drv.picks(cell, batches)
