"""The manifest, the discovery of each cell's files by name, the import
check, and the weights and reference against the program at a small
size."""
import dataclasses
import json
import re

import pytest
import torch

from conftest import CELLS, DENSE, HYBRID, ROOT
from portbench import bench
from portbench.reference import decoder

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    b = _manifest()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()
                                  ["workloads"]])
def test_cell_files_found_by_name(cell):
    c = bench.Cell(ROOT, cell, 1, 1.0, True, device=torch.device("cpu"))
    assert c.traffic["kind"] in ("train", "serve")
    assert c.driver().run
    assert set(c.limits["limits"]) and all(
        v is not None and v > 0 for v in c.limits["limits"].values())
    readers = c.readers()
    assert set(readers) == {m["name"] for m in c.per_layer}
    for mod in readers.values():
        for k in getattr(mod, "ROOFLINES", ()):
            assert c.roofline(k).WRAPS
    assert c.model_config().num_layers == c.model["num_layers"]


def test_import_check_compares_whole_names():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.models"]) \
        == []
    assert bench.forbidden_modules(["repro_torch", "repro.models.model"]) \
        == ["repro"]
    assert bench.forbidden_modules(["jax.numpy", "flax", "jaxlib.x"]) == [
        "flax", "jax", "jaxlib"]
    assert bench.forbidden_modules() == []


def test_import_check_fails_a_run(tiny_root, monkeypatch):
    """A planted `repro` module refuses the run; `repro_torch` passes."""
    import types
    monkeypatch.setitem(__import__("sys").modules, "repro",
                        types.ModuleType("repro"))
    cell = bench.Cell(tiny_root, "tiny-serve", 3, 0.2, False,
                      device=torch.device("cpu"))
    with pytest.raises(bench.Refused, match="repro"):
        bench.execute(cell, 0.0)


@pytest.mark.parametrize("model", [DENSE, HYBRID], ids=["dense", "hybrid"])
def test_weights_have_the_program_layout(model):
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cell = bench.Cell.__new__(bench.Cell)
    cell.model = model
    cfg = bench.Cell._model_config(cell)
    want = M.init_params(torch.Generator().manual_seed(0), cfg)
    got = decoder.make_params(model, 5, "cpu")
    shapes = tree_map(lambda a, b: (a.shape, a.dtype) == (b.shape, b.dtype),
                      want, got)
    assert json.dumps(shapes) and all(
        v for v in _leaves(shapes)), shapes
    again = decoder.make_params(model, 5, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                 _leaves(again)))


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


@pytest.mark.parametrize("model", [DENSE, HYBRID], ids=["dense", "hybrid"])
def test_reference_matches_the_program_in_float32(model):
    """Served in float32, the program's tokens are the reference's best
    and its logits the reference's: at the prefill's position to float32
    rounding, at the decode steps' to the rounding of the program's
    bf16 kv cache (its cache dtype whatever the model's)."""
    from repro_torch.launch.serve import serve
    m = dict(model, param_dtype="float32", compute_dtype="float32")
    cell = bench.Cell.__new__(bench.Cell)
    cell.model = m
    cfg = bench.Cell._model_config(cell)
    params = decoder.make_params(m, 11, "cpu")
    prompts = torch.randint(0, m["vocab_size"], (2, 12),
                            generator=torch.Generator().manual_seed(1))
    toks, _, logits = serve(cfg, batch=2, prompt_len=12, gen=5,
                            params=params, prompts=prompts, device="cpu")
    ref = decoder.served_logits(params, m, prompts, toks)
    got = logits[..., :m["vocab_size"]]
    assert float(decoder.token_gap(ref, toks).max()) <= 2e-3
    assert torch.allclose(got[:, 0], ref[:, 0], atol=1e-6)
    assert torch.allclose(got, ref, atol=2e-3)


def test_reference_training_matches_the_program_in_float32():
    """The reference's first steps are the program's, in float32, from
    the cell's step counter (the working weights are then the master)."""
    from portbench import generate
    drv = bench.load_file(ROOT / "portbench/drivers/train.py", "drv_t")
    m = dict(DENSE, param_dtype="float32", compute_dtype="float32")
    cell = bench.Cell.__new__(bench.Cell)
    cell.model, cell.reference = m, decoder
    cell.traffic = CELLS["tiny-train"][1]
    params = decoder.make_params(m, 4, "cpu")
    batches = generate.train_batches(cell.traffic, 256, 4, "cpu")[:3]
    _, _, prog = drv.first_steps(cell, params, batches)
    refr = drv.reference_readings(cell, decoder.make_params(m, 4, "cpu"),
                                  batches)
    got = drv.compare(prog, refr)
    assert got["loss"] < 1e-6 and got["grad_norm"] < 1e-4
    assert got["change_norm"] < 1e-3 and got["param_change"] < 1e-3
    assert refr["param_change"] == refr["change"]
