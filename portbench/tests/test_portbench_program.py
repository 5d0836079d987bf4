"""The readers of the program's own spans and counters (`repro_torch.obs`,
`metrics/_program.py`) in traced CPU runs of the small cells: each reads
a value in its range, and the breakdown's idle gaps name the program's
spans."""
import pytest
import torch

from portbench import bench

# metric: (small cell, lowest, highest reading)
READS = {"backward_share.train": ("tiny-train", 0.0, 1.0),
         "optimizer_share.train": ("tiny-train", 0.0, 1.0),
         "mamba_scan_share": ("tiny-hy-serve", 0.0, 1.0),
         "moe_dispatch_share": ("tiny-hy-serve", 0.0, 1.0),
         # at most K x N choices over E x C = 1.25 K N slots in a prefill
         "moe_slot_fill": ("tiny-hy-serve", 0.0, 0.8),
         # 2 rows x top-2 of 4 experts at C = 1
         "moe_experts_hit": ("tiny-hy-serve", 0.25, 1.0)}


def _traced(root, cell, seed):
    """A traced run's trace view, per-layer readings and program spans,
    with bench.execute's steps."""
    from repro_torch import obs
    c = bench.Cell(root, cell, seed, 0.5, True, device=torch.device("cpu"))
    driver = c.driver()
    readers = c.readers()
    assert obs.enabled()
    tracer = bench._tracer(c, readers, driver)
    out = driver.run(c, bench.Window(c, tracer))
    view = tracer.view(out["window_s"])
    run = bench.Run(c, out, view)
    got = {m["name"]: readers[m["name"]].read(run) for m in c.per_layer}
    assert not obs.enabled()
    return view, got


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-hy-serve"])
def test_program_metrics_read_in_range(tiny_root, cell):
    view, got = _traced(tiny_root, cell, 31)
    mine = {n: r for n, r in READS.items() if r[0] == cell}
    for name, (_, lo, hi) in mine.items():
        assert got[name] is not None and lo <= got[name] <= hi, (name, got)
    names = {r["name"] for r in view.program_records}
    want = ({"train.step", "train.forward", "train.backward",
             "train.optimizer"} if cell == "tiny-train" else
            {"serve.batch", "serve.prefill", "serve.decode_step",
             "model.mamba", "model.mamba.scan", "model.moe",
             "model.moe.route", "model.moe.experts"})
    assert want <= names
    assert all(view.t0 <= r["start_ns"] <= view.t1
               for r in view.program_records)
    # a CPU run has no device work: plant two device intervals around the
    # middle of a program span that holds no shorter host span (none of
    # its calls is wrapped by the benchmark), so that the device idles
    # inside it
    name = "train.optimizer" if cell == "tiny-train" else "model.moe.route"
    leaf = max((r for r in view.program_records if r["name"] == name),
               key=lambda r: r["end_ns"] - r["start_ns"])
    mid = (leaf["start_ns"] + leaf["end_ns"]) // 2
    view.gpu = [(view.t0, mid - 1, "k"), (mid + 1, view.t1, "k")]
    view._merged = view._merge()
    gaps = dict(view.idle_gaps())
    assert gaps == {leaf["name"]: 2e-9}, gaps


def test_program_without_spans_reads_nothing(tiny_root, monkeypatch):
    """Over a program without `repro_torch.obs` (the parent of the change
    that added it), the readers report nothing and the run is sound."""
    import sys
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    monkeypatch.delattr(repro_torch, "obs")
    c = bench.Cell(tiny_root, "tiny-hy-serve", 32, 0.3, True,
                   device=torch.device("cpu"))
    result = bench.execute(c, 0.0)
    assert result["correct"] is True
    assert not set(READS) & set(result["metrics"])
