"""The port's streaming checkpointer: the reference's checkpoint tests
(tests/test_checkpoint.py) run on `repro_torch`, resume through the port's
train loop, and checkpoints carried across the two packages bit for bit."""
import json
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cfg_pair  # noqa: E402
from repro.core.streaming_checkpoint import \
    StreamingCheckpointer as JCheckpointer  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.core.streaming_checkpoint import (  # noqa: E402
    CKPT_CHUNK_BYTES, StreamingCheckpointer, _leaf_paths)
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture
def state():
    _, tc = cfg_pair("qwen3-32b", smoke=True, f32=False)
    params = TM.init_params(torch.Generator().manual_seed(0), tc)
    return adamw_init(params, OptimizerConfig())


def _raw(x) -> bytes:
    """A leaf's bytes: a tensor's raw bytes (bf16 as its bit patterns), a
    jax array's, or an int's as the 0-d int32 it is stored as."""
    if isinstance(x, int):
        return np.int32(x).tobytes()
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_trees_equal(a, b):
    """Same leaf paths, dtypes and shapes, and the same bytes."""
    pa, pb = list(_leaf_paths(a)), list(_leaf_paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        assert type(x) is type(y), path
        if isinstance(x, torch.Tensor):
            assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        assert _raw(x) == _raw(y), path


def _zeros_like(state):
    """A `like` TrainState of fresh zeros, so that restore cannot pass by
    handing back the tensors it was given."""
    return type(state)(0, *(None if t is None else
                            tree_map(torch.zeros_like, t)
                            for t in state[1:]))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on the port
# ---------------------------------------------------------------------------


def test_roundtrip_exact(tmp_path, state):
    ck = StreamingCheckpointer(tmp_path)
    ck.save(3, state)
    rest = ck.restore(_zeros_like(state))
    _assert_trees_equal(state, rest)


def test_bounded_buffer(tmp_path, state):
    """Peak in-flight bytes ~ buffers * chunk, not the full tree size."""
    total = sum(x.nbytes for x in tree_leaves(state[1:]))
    ck = StreamingCheckpointer(tmp_path, chunk_bytes=8192, buffers=2)
    ck.save(1, state)
    assert ck.metrics.bytes_written >= total * 0.95
    assert ck.metrics.peak_buffer_bytes < total / 4, \
        (ck.metrics.peak_buffer_bytes, total)
    # the port's writer admits at most `buffers` chunks at a time; a chunk
    # is at least one row of its leaf (here up to 16 KiB)
    chunks = [c["nbytes"] for m in json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
        ["leaves"].values() for c in m["chunks"]]
    assert ck.metrics.peak_buffer_bytes <= 2 * max(chunks)
    assert len(chunks) == ck.metrics.n_chunks > ck.metrics.n_leaves


def test_atomic_commit_survives_partial(tmp_path, state):
    ck = StreamingCheckpointer(tmp_path)
    ck.save(5, state)
    # simulate a crash mid-save of step 9: stray tmp dir + garbage file
    tmp = tmp_path / ".tmp_step_00000009"
    tmp.mkdir()
    (tmp / "leaf_00000.bin").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    rest = ck.restore(_zeros_like(state))
    _assert_trees_equal(state, rest)


def test_corruption_detected(tmp_path, state):
    ck = StreamingCheckpointer(tmp_path)
    d = ck.save(2, state)
    # flip bytes in one leaf file
    f = sorted(d.glob("leaf_*.bin"))[0]
    raw = bytearray(f.read_bytes())
    raw[0] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        ck.restore(_zeros_like(state))


def test_gc_keeps_latest(tmp_path, state):
    ck = StreamingCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.all_steps() == [3, 4]


def test_resume_training_equivalence(tmp_path):
    """Through the port's train loop: 6 steps straight == 3 steps, a
    checkpoint, a fresh loop that resumes from it and runs 3 more. The
    final states are equal bit for bit, and the resumed steps' losses equal
    the straight run's (the resumed loop feeds step i the dataset's batch
    i)."""
    _, tc = cfg_pair("qwen3-32b", smoke=True)
    kw = dict(steps=6, batch=4, seq=16, seed=1, log_every=100, device="cpu")
    s_a, info_a = train_loop(tc, **kw)
    # the same run with a checkpoint every 3 steps, cut after step 3: its
    # later checkpoint removed, as if the run had died before writing it
    _, info_b = train_loop(tc, ckpt_dir=tmp_path, ckpt_every=3, **kw)
    assert info_b["losses"] == info_a["losses"]
    ck = StreamingCheckpointer(tmp_path)
    assert ck.all_steps() == [3, 6]
    shutil.rmtree(tmp_path / "step_00000006")
    s_b, info_b = train_loop(tc, ckpt_dir=tmp_path, resume=True, **kw)
    assert s_b.step == 6 and len(info_b["losses"]) == 3
    assert info_b["losses"] == info_a["losses"][3:]
    _assert_trees_equal(s_a, s_b)
    assert ck.all_steps() == [3, 6]
    # resuming with nothing left to run restores and saves again
    s_c, info_c = train_loop(tc, ckpt_dir=tmp_path, resume=True, **kw)
    assert info_c["losses"] == [] and s_c.step == 6
    _assert_trees_equal(s_a, s_c)


def test_resave_same_step_idempotent(tmp_path, state):
    """Re-saving an existing step must replace it, not crash (the train
    loop's final save can coincide with a periodic save)."""
    ck = StreamingCheckpointer(tmp_path)
    ck.save(7, state)
    ck.save(7, state)
    assert ck.all_steps() == [7]
    rest = ck.restore(_zeros_like(state))
    _assert_trees_equal(state, rest)


# ---------------------------------------------------------------------------
# The port's own details
# ---------------------------------------------------------------------------


def test_manifest_format(tmp_path, state):
    """The reference's layout: numpy dtype names, a 0-d int32 step leaf,
    NamedTuple fields as path parts, no leaves for None; the chunk size is
    the reference's 64 MiB."""
    assert CKPT_CHUNK_BYTES == 64 * 1024 * 1024
    ck = StreamingCheckpointer(tmp_path)
    d = ck.save(4, state._replace(step=4))
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 4
    leaves = man["leaves"]
    assert leaves["step"]["dtype"] == "int32" and leaves["step"]["shape"] == []
    assert {m["dtype"] for m in leaves.values()} == {"int32", "bfloat16",
                                                     "float32"}
    assert "params/embed" in leaves and "master/embed" in leaves
    assert [f"leaf_{i:05d}.bin" for i in range(len(leaves))] == [
        m["file"] for m in leaves.values()]
    rest = ck.restore(_zeros_like(state))
    assert rest.step == 4 and isinstance(rest.step, int)
    int8 = adamw_init(state.params, OptimizerConfig(state_dtype="int8"))
    ck.save(5, int8)
    man = json.loads((tmp_path / "step_00000005" / "manifest.json")
                     .read_text())
    assert "master/embed" not in man["leaves"]
    assert man["leaves"]["m/embed/q"]["dtype"] == "int8"


def test_writer_error_is_raised(tmp_path, state, monkeypatch):
    """A failed chunk write surfaces from save, nothing is committed, and
    the writer does not leave the caller blocked."""
    ck = StreamingCheckpointer(tmp_path, chunk_bytes=4096, buffers=1)
    ck.save(1, state)
    calls = {"n": 0}
    real_open = open

    class Failing:
        def __init__(self, fh):
            self.fh = fh

        def write(self, data):
            calls["n"] += 1
            raise OSError("disk full")

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.fh.close()

    import builtins
    monkeypatch.setattr(builtins, "open", lambda p, mode="r", *a, **k:
                        Failing(real_open(p, mode, *a, **k))
                        if "w" in mode and str(p).endswith(".bin")
                        else real_open(p, mode, *a, **k))
    with pytest.raises(OSError, match="disk full"):
        ck.save(2, state)
    monkeypatch.undo()
    assert calls["n"] >= 1
    assert ck.all_steps() == [1]


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def _jax_state(state_dtype, with_ef=False):
    """A reference TrainState after one train step (nonzero moments),
    qwen3-32b smoke: bf16 params, float32 or int8 moments; with `ef`, the
    error feedback holds random bf16 values."""
    jc, _ = cfg_pair("qwen3-32b", smoke=True, f32=False)
    oc = JOptimizerConfig(state_dtype=state_dtype,
                          master=state_dtype == "float32")
    st = jax_adamw_init(JM.init_params(jax.random.PRNGKey(0), jc), oc,
                        with_ef=with_ef)
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 17),
                                             dtype=np.int32)
    st, _ = jax.jit(jax_make_train_step(jc, oc))(
        st, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    if with_ef:
        rng = np.random.default_rng(1)
        st = st._replace(ef=jax.tree.map(lambda e: jax.numpy.asarray(
            rng.standard_normal(e.shape) * 1e-3, jax.numpy.bfloat16), st.ef))
    return st


def _manifest(d):
    return json.loads((d / "manifest.json").read_text())


@pytest.mark.parametrize("with_ef", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_checkpoints_cross_packages(tmp_path, state_dtype, with_ef):
    """The reference saves a TrainState and the port restores it; the port
    saves the same state and the reference restores it. Every leaf equal
    bit for bit both ways; both manifests have the same leaf paths, dtype
    strings, shapes, files and chunks (small chunks, so leaves span
    several). With `ef`, its leaves are among them."""
    jstate = _jax_state(state_dtype, with_ef)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert tstate.step == 1

    jck = JCheckpointer(tmp_path / "jax", chunk_bytes=4096)
    jdir = jck.save(1, jstate)
    got = StreamingCheckpointer(tmp_path / "jax").restore(
        _zeros_like(tstate))
    assert got.step == 1
    for (path, g), (_, w) in zip(_leaf_paths(got), _leaf_paths(tstate)):
        assert _raw(g) == _raw(w), path
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        t = got
        for key in path:
            t = (getattr(t, key.name) if hasattr(key, "name")
                 else t[getattr(key, "key", getattr(key, "idx", None))])
        assert _raw(t) == np.asarray(leaf).tobytes(), \
            jax.tree_util.keystr(path)

    tck = StreamingCheckpointer(tmp_path / "torch", chunk_bytes=4096)
    tdir = tck.save(1, tstate)
    back = JCheckpointer(tmp_path / "torch").restore(
        jax.eval_shape(lambda: jstate))
    for (path, b), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert b.dtype == w.dtype and b.shape == w.shape
        assert np.asarray(b).tobytes() == np.asarray(w).tobytes(), \
            jax.tree_util.keystr(path)

    jm, tm = _manifest(jdir), _manifest(tdir)
    assert any(p.startswith("ef/") for p in tm["leaves"]) == with_ef
    assert set(jm["leaves"]) == set(tm["leaves"])
    assert {p: m["dtype"] for p, m in jm["leaves"].items()} == \
        {p: m["dtype"] for p, m in tm["leaves"].items()}
    assert jm == tm
