"""The port's serve path as a whole, its device rule, and its import
boundary (no jax, no repro)."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cfg_pair, jax_to_torch  # noqa: E402
from repro.launch.serve import serve as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_greedy_tokens_match_reference(use_kernels):
    """f32 smoke h2o-danube (window 32), prompt 40 > window, gen 8: the
    port decodes the same greedy tokens as the reference with its Pallas
    kernels, on the reference's weights and prompts."""
    jc, tc = cfg_pair("h2o-danube-1.8b", smoke=True)
    assert jc.sliding_window == 32
    B, P, G, seed = 2, 40, 8, 0
    want, _ = jax_serve(jc, batch=B, prompt_len=P, gen=G, seed=seed,
                        use_pallas=True)
    # the same weights and prompts the reference's serve made from seed
    params = jax_to_torch(JM.init_params(jax.random.PRNGKey(seed), jc, tp=1))
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(seed + 1),
                                          (B, P), 0, jc.vocab_size))
    before = (fops.flash_attention.launches, dops.decode_attention.launches)
    got, stats, logits = tserve.serve(
        tc, batch=B, prompt_len=P, gen=G, seed=seed, device="cpu",
        use_kernels=use_kernels, params=params,
        prompts=torch.from_numpy(prompts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert logits.shape == (B, G, tc.padded_vocab())
    assert (logits.argmax(-1) == got).all()
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0
    assert 0 < stats["decode_first_step_s"] < stats["decode_s"]
    assert stats["decode_steady_step_s"] * (G - 2) == pytest.approx(
        stats["decode_s"] - stats["decode_first_step_s"])
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (fops.flash_attention.launches,
            dops.decode_attention.launches) == before


def test_default_device_is_the_card():
    """No card here: the default device raises rather than using the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    _, tc = cfg_pair("h2o-danube-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(tc, batch=1, prompt_len=4, gen=2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
        "--batch", "2", "--prompt-len", "8", "--gen", "3", "--no-kernels"])
    tserve.main()
    out = capsys.readouterr().out
    assert "generated shape: (2, 3)" in out and "decode_tokens_per_s" in out


def test_port_imports_neither_jax_nor_repro():
    """Every module under repro_torch imports with jax and repro blocked."""
    code = f"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {str(SRC)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
# the modules of the MoE / Mamba / checkpoint slice among them
assert {{"repro_torch.core.streaming_checkpoint", "repro_torch.models.layers",
         "repro_torch.models.model", "repro_torch.launch.train"}} <= set(names)
from repro_torch.models.layers import moe_ffn, mamba, _mamba_ssm_chunked
from repro_torch.core.streaming_checkpoint import StreamingCheckpointer
assert sys.modules["jax"] is None and sys.modules["repro"] is None
assert not any(m.startswith(("jax.", "repro.")) for m in sys.modules)
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 26     # the walk saw the package
