"""The PyTorch port's example twins (examples/*_torch.py) run end to end
on the CPU at reduced sizes: each `main()` with `--device cpu`."""
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and the
    multi-rank tests' time limits are not this file's to spend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_torch():
    out = _example("quickstart").main(["--device", "cpu", "--steps", "4"])
    assert len(out["losses"]) == 4
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["losses"][-1] < out["losses"][0]
    assert tuple(out["tokens"].shape) == (2, 12)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen3-32b"])
def test_serve_batched_torch(arch):
    out = _example("serve_batched").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2",
         "--prompt-len", "16", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["stats"]["prefill_tokens_per_s"] > 0


def test_elastic_recovery_torch():
    out = _example("elastic_recovery").main(
        ["--device", "cpu", "--steps", "12", "--fail-at", "8"])
    assert out["step"] == 12 and out["recoveries"] == 1
    assert out["checkpoints"] == [0, 5, 10]
    assert [list(map(int, e)) for e in out["evicted"]] == [[5]]


def test_train_e2e_torch_loss_falls(tmp_path):
    info = _example("train_e2e").main(
        ["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "16",
         "--ckpt-dir", "",
         "--log-path", str(tmp_path / "log.jsonl")])
    losses = info["losses"]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    assert (tmp_path / "log.jsonl").exists()
