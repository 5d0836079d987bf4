"""The yardstick's frozen arithmetic against the program's and against
the known figures."""
import dataclasses
import json

import pytest

from conftest import ROOT
from portbench import bench, flops

CONFIGS = {"h2o-danube-1.8b": ("h2o-danube-1.8b", None),
           "jamba-v0.1-52b-p1": ("jamba-v0.1-52b", 8)}


def _model(name):
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())["model"]


def _program(name):
    from repro_torch.configs import get_config
    arch, layers = CONFIGS[name]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_count_matches_program(name):
    assert flops.param_count(_model(name)) == _program(name).param_count()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kind,batch,seq", [("train", 4, 2048),
                                            ("prefill", 4, 4096),
                                            ("decode", 64, 1100)])
def test_model_flops_match_program(name, kind, batch, seq):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import model_flops_per_step
    want = model_flops_per_step(_program(name),
                                ShapeConfig("x", seq, batch, kind))
    assert flops.model_flops(_model(name), kind, batch, seq) == want


def test_known_figures():
    # h2o-danube-1.8b, a 4 x 2048 train step: 9.62e13 model FLOPs
    f = flops.model_flops(_model("h2o-danube-1.8b"), "train", 4, 2048)
    assert f == pytest.approx(9.62e13, rel=1e-3)
    # flash at h2o's 4 x 4160 prefill (window 4096): 3.5e11 FLOP
    fa = bench.load_file(ROOT / "portbench/rooflines/flash_attention.py",
                         "fa")
    call = {"q": (4, 4160, 32, 80), "k": (4, 4160, 8, 80), "itemsize": 2,
            "dtype": "bfloat16", "causal": True, "window": 4096}
    fl, nbytes, _ = fa.cost(call)
    assert fl == pytest.approx(3.544e11, rel=1e-3)
    assert nbytes == 2 * (2 * 4 * 4160 * 32 * 80 + 2 * 4 * 4160 * 8 * 80)
    # bound by operations: 0.3584 ms (chip_smoke.py's kernel table)
    assert fa.bound_s(call) * 1e3 == pytest.approx(0.3584, rel=1e-3)


def test_decode_roofline_counts_valid_slots():
    da = bench.load_file(ROOT / "portbench/rooflines/decode_attention.py",
                         "da")
    call = {"q": (4, 1, 32, 80), "k": (4, 4096, 8, 80), "valid": 4096,
            "itemsize": 2, "dtype": "bfloat16"}
    fl, nbytes, _ = da.cost(call)
    assert fl == 4.0 * 4 * 32 * 80 * 4096
    # h2o's decode cache, both halves, plus q, out and the mask: 42 MB
    assert nbytes == pytest.approx(42.0e6, rel=0.01)
    half = dict(call, valid=2048)
    assert da.cost(half)[1] < nbytes
