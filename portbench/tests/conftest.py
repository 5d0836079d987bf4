"""Fixtures of the benchmark's tests: a temporary copy of the benchmark
with throwaway cells at a size the CPU runs in seconds, added as a later
change would add them: new configuration, traffic and check files and
new BENCHMARK.json entries, no edit to any file of the harness."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
       "grad_clip": 1.0, "warmup": 100, "total_steps": 10000}
TOKENS = {"distribution": "zipf_markov", "jump": 0.75}
DENSE = {"name": "tiny-dense", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256, "sliding_window": 24,
         "rope_theta": 10000.0, "norm_eps": 1e-5, "tie_embeddings": False,
         "param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
HYBRID = {"name": "tiny-hybrid", "family": "hybrid", "num_layers": 8,
          "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
          "d_ff": 128, "vocab_size": 256, "rope_theta": 1e6,
          "norm_eps": 1e-5, "tie_embeddings": False, "attn_every": 8,
          "mamba": {"d_state": 8, "d_conv": 4, "expand": 2},
          "moe": {"num_experts": 4, "top_k": 2, "d_ff": 64,
                  "capacity_factor": 1.25, "dispatch": "einsum"},
          "moe_every": 2, "param_dtype": "bfloat16",
          "compute_dtype": "bfloat16"}
# cell: (configuration, traffic, limits, like-cell whose metrics it joins)
CELLS = {
    "tiny-train": (DENSE, {"kind": "train", "batch": 4, "seq_len": 32,
                           "tokens": TOKENS, "pool": 4, "first_steps": 3,
                           "start_step": 100, "optimizer": OPT},
                   {"loss": 0.001, "grad_norm": 0.05, "change_norm": 0.05,
                    "param_change": 0.05},
                   "h2o-train-4x2048"),
    "tiny-serve": (DENSE, {"kind": "serve", "batch": 3, "prompt_len": 28,
                           "gen": 8, "tokens": TOKENS, "pool": 2,
                           "check_batches": 2},
                   {"gap": 0.2}, "jamba-prefill-4x4096"),
    "tiny-hy-serve": (HYBRID, {"kind": "serve", "batch": 2, "prompt_len": 16,
                               "gen": 6, "tokens": TOKENS, "pool": 2,
                               "check_batches": 1},
                      {"gap_mean": 0.1}, "jamba-prefill-4x4096"),
}
PROBE = '''"""A throwaway per-layer metric: batches served in the window."""


def read(run):
    return float(run.work["batches"])
'''


def add_cells(root: Path) -> None:
    """Add CELLS (and the probe metric) to the copy at `root`."""
    pb = root / "portbench"
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in (DENSE, HYBRID):
        (pb / "configs" / f"{m['name']}.json").write_text(json.dumps(
            {"name": m["name"], "source": "test", "reduced": [],
             "reference": "decoder", "model": m}))
        b["configs"].append({"name": m["name"], "source": "test",
                             "file": f"portbench/configs/{m['name']}.json",
                             "reduced": [], "why": "test"})
    for name, (cfg, traffic, limits, like) in CELLS.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        (pb / "checks" / f"{name}.json").write_text(
            json.dumps({"limits": limits}))
        b["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": name, "chips": 1, "why": "test"})
        for m in b["end_to_end"] + b["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    (pb / "metrics" / "probe_batches.py").write_text(PROBE)
    b["per_layer"].append({"name": "probe_batches", "unit": "batches",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "serve_tokens_per_s",
                           "workloads": ["tiny-serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of BENCHMARK.json and portbench/ beside the program, with
    the throwaway cells."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    add_cells(root)
    return root
