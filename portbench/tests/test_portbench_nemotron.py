"""The serving cell of nemotron-3-nano-30b-a3b (`nemotron_h.py`, the layer
pattern's blocks) driven end to end on the CPU at a small size, as the
cell's files have it but for the sizes: a sound run is correct, traced
and untraced, and reads the cell's new per-layer metrics; a planted
fault (the router's correction bias dropped, a frozen or an altered
decode token) is not correct."""
import contextlib
import io
import json
import math
import shutil

import pytest
import torch

from conftest import ROOT, TOKENS
from portbench import bench, faults

CELL = "nemotron-prefill-2x8192"
TINY = "tiny-nemotron-serve"
# float32: at this size bf16's flipped expert choices read gaps as large
# as a dropped correction bias does, in float32 a sound run reads 0
MODEL = {"name": "tiny-nemotron", "family": "hybrid", "num_layers": 8,
         "d_model": 256, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 256, "vocab_size": 256, "norm_eps": 1e-5,
         "tie_embeddings": False, "layer_pattern": "MEM*EME*",
         "use_rope": False,
         "mamba": {"d_state": 8, "d_conv": 4, "expand": 2, "n_heads": 4,
                   "head_dim": 8, "n_groups": 2, "chunk": 4},
         "moe": {"num_experts": 8, "top_k": 2, "d_ff": 256,
                 "capacity_factor": 1.25, "num_shared_experts": 1,
                 "shared_d_ff": 256, "router": "sigmoid_bias",
                 "activation": "relu2", "routed_scaling": 2.5,
                 "dispatch": "scatter"},
         "param_dtype": "float32", "compute_dtype": "float32"}
TRAFFIC = {"kind": "serve", "batch": 4, "prompt_len": 18, "gen": 8,
           "tokens": TOKENS, "pool": 2, "check_batches": 2}
# seeds 41-46: a sound run read gap_mean 0-0.002, the dropped bias
# 0.045-0.069
LIMITS = {"gap_mean": 0.01, "share_over_0.5": 0.1}
# the cell's per-layer metrics that a CPU run reads, and those that read
# the device's trace
ON_CPU = {"mamba2_share", "mamba2_scan_share", "moe_drop_share",
          "moe_dispatch_share.nemotron", "mfu.nemotron",
          "moe_experts_hit.nemotron", "decode_step_ms",
          "prefill_tokens_per_s"}
ON_DEVICE = {"idle_share.nemotron", "flash_roofline.nemotron",
             "decode_attn_roofline.nemotron"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of BENCHMARK.json and portbench/ beside the program, with the
    small cell added beside the real one: its own configuration (the
    real one's reference), traffic and check files, and its name beside
    the real cell's in every metric's list of cells."""
    root = tmp_path_factory.mktemp("nemotron")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    pb = root / "portbench"
    real = json.loads((pb / "configs" / "nemotron-3-nano-30b-a3b.json")
                      .read_text())
    (pb / "configs" / "tiny-nemotron.json").write_text(json.dumps(
        {"name": "tiny-nemotron", "source": "test", "reduced": [],
         "reference": real["reference"], "model": MODEL}))
    (pb / "traffic" / f"{TINY}.json").write_text(json.dumps(TRAFFIC))
    (pb / "checks" / f"{TINY}.json").write_text(json.dumps(
        {"limits": LIMITS}))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-nemotron", "source": "test",
                         "file": "portbench/configs/tiny-nemotron.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": TINY, "config": "tiny-nemotron",
                           "traffic": TINY, "chips": 1, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


def drop_bias():
    """A router that chooses by the sigmoid scores alone, its correction
    bias dropped."""
    from repro_torch.models import layers

    def make(real):
        def route(p, *a, **k):
            if "router_bias" in p:
                p = {**p, "router_bias": torch.zeros_like(p["router_bias"])}
            return real(p, *a, **k)
        return route
    return faults.patched(layers, "_moe_route", make)


def _run(root, seed, trace=False, fault=None):
    c = bench.Cell(root, TINY, seed, 0.3, trace, device=torch.device("cpu"))
    out = io.StringIO()
    with (fault() if fault else contextlib.nullcontext()), \
            contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        bench.emit(bench.execute(c, 0.0))
    return c, json.loads(out.getvalue().strip().splitlines()[-1])


def test_cell_files_name_the_reference_and_metrics():
    """The real cell's files: the configuration runs the Nemotron-H
    reference, whole (nothing reduced), and every per-layer metric it
    lists has a reader."""
    c = bench.Cell(ROOT, CELL, 0, 0.0, False, device=torch.device("cpu"))
    assert c.config["reference"] == "nemotron_h"
    assert c.config["reduced"] == []
    assert c.model["layer_pattern"] == c.config["hybrid_override_pattern"]
    assert {m["name"] for m in c.per_layer} == ON_CPU | ON_DEVICE
    assert set(c.readers()) == {m["name"] for m in c.per_layer}
    assert {m["name"] for m in c.e2e} == {"serve_tokens_per_s",
                                          "request_p95_ms", "setup_s"}


def test_frozen_flop_count_matches_program():
    """`mfu.nemotron`'s frozen N_active is the program's active count less
    the input embedding (3.23 B), and a prefill is 2 N_active a token plus
    the '*' blocks' causal attention."""
    from repro_torch.configs import get_config
    m = json.loads((ROOT / "portbench" / "configs" /
                    "nemotron-3-nano-30b-a3b.json").read_text())["model"]
    mfu = bench.load_file(ROOT / "portbench/metrics/mfu.nemotron.py", "mfu")
    _, active = get_config("nemotron-3-nano-30b-a3b").param_count()
    assert mfu.active_params(m) == active - 131072 * 2688 == 3_227_754_816
    att = 4.0 * 32 * 128 * 8192 * 6 * 2 * 8192 * 0.5
    assert mfu.model_flops(m, "prefill", 2, 8192) == \
        2.0 * 3_227_754_816 * 2 * 8192 + att


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_sound_run_is_correct(root, trace):
    c, last = _run(root, 41, trace)
    assert last["correct"] is True, last["checks"]
    assert set(last["checks"]) == set(LIMITS)
    if not trace:
        assert set(last["metrics"]) == {m["name"] for m in c.e2e}
        return
    got = {k: v["value"] for k, v in last["metrics"].items()}
    assert set(got) == ON_CPU, got
    assert all(math.isfinite(v) and v >= 0 for v in got.values()), got
    assert got["mfu.nemotron"] < 1 and got["moe_drop_share"] < 1


@pytest.mark.parametrize("fault", ["drop_bias", "frozen", "token"])
def test_fault_is_caught(root, fault):
    make = (drop_bias if fault == "drop_bias"
            else faults.FAULTS["serve"][fault])
    _, last = _run(root, 42, fault=make)
    assert last["correct"] is False, last["checks"]


def test_batches_in_one_forward_read_as_each_alone(root, monkeypatch):
    """The reference's forward over several served batches, each routed as
    its own, gives each batch's gaps as a forward over it alone; routing
    the rows together would drop other choices."""
    from portbench import generate
    from portbench.reference import nemotron_h as ref
    c = bench.Cell(root, TINY, 43, 0.0, False, device=torch.device("cpu"))
    drv = c.driver()
    params = ref.make_params(c.model, 43, "cpu")
    pool = generate.prompt_batches(c.traffic, c.model["vocab_size"], 43,
                                   "cpu")
    done = drv.serve_batches(c, params, pool, count=3)
    picks = [0, 1, 2]
    joined = drv.gaps(c, params, pool, done, picks)
    monkeypatch.setattr(ref, "BATCHES_A_FORWARD", 1)
    alone = drv.gaps(c, params, pool, done, picks)
    assert len(joined) == len(alone) == 3
    for a, b in zip(joined, alone):
        assert a.shape == b.shape == (4, 8)
        assert torch.allclose(a, b, atol=1e-4), (a - b).abs().max()
    prompts = torch.cat([pool[0], pool[1]])
    served = torch.cat([done[0][3], done[1][3]])
    each = ref.served_logits(params, c.model, prompts, served, batch=4)
    whole = ref.served_logits(params, c.model, prompts, served)
    assert not torch.allclose(each, whole, atol=1e-3)
