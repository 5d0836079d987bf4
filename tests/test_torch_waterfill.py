"""The port's water-fill solver (`repro_torch.sim.alloc`) against the
reference's numpy allocator, bitwise: random instances with forced ties,
dead resources, zero capacities and one-flow components; the capacity
fold against `np.subtract.at`; and the solver in place of the
reference's jit solver inside a simulator run, whose event trace must
equal the numpy solver's."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import repro.sim.alloc as ralloc  # noqa: E402
from repro.sim import Fabric, lovelock_cluster  # noqa: E402
from repro.sim import pipelined_shuffle_waves, shuffle  # noqa: E402
from repro_torch.sim.alloc import (subtract_holds_,  # noqa: E402
                                   vector_water_fill,
                                   vector_water_fill_torch)


def _instance(seed):
    """A CSR incidence and capacities: up to 300 flows of 1-4 holds over
    up to 40 resources, some of which nobody holds (dead: inf or nan fair
    shares). Odd seeds draw integer capacities 0-3, so fair shares tie
    and some are zero; every fifth seed lets a flow hold a resource
    twice; every seventh gives each flow a resource of its own (one-flow
    components)."""
    rng = np.random.default_rng(seed)
    nf = int(rng.integers(1, 300))
    nres = int(rng.integers(1, 40))
    indptr, indices = [0], []
    for i in range(nf):
        if seed % 7 == 0:
            cols = [i]
        else:
            k = int(rng.integers(1, min(4, nres) + 1))
            cols = list(rng.choice(nres, size=k, replace=seed % 5 == 0))
        indices.extend(int(c) for c in cols)
        indptr.append(len(indices))
    nres = max(nres, max(indices) + 1) + int(rng.integers(0, 4))  # dead
    if seed % 2:
        cap = rng.integers(0, 4, size=nres).astype(np.float64)
    else:
        cap = rng.uniform(0.1, 5.0, size=nres)
    return (np.asarray(indptr, dtype=np.int64),
            np.asarray(indices, dtype=np.int64), cap)


@given(st.integers(0, 100_000))
@settings(max_examples=60, deadline=None)
def test_torch_water_fill_bitwise_matches_reference(seed):
    """Bitwise (not approx) against `repro.sim.alloc.vector_water_fill`;
    the port's numpy copy too."""
    indptr, indices, cap = _instance(seed)
    want = ralloc.vector_water_fill(indptr, indices, cap.copy())
    got = vector_water_fill_torch(indptr, indices, cap.copy(), device="cpu")
    assert got.dtype == np.float64
    assert got.tobytes() == want.tobytes()
    assert vector_water_fill(indptr, indices, cap.copy()).tobytes() == \
        want.tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_torch_water_fill_at_jit_sizes(seed):
    """Components of 192-640 flows, sizes the array core hands the jit
    solver."""
    rng = np.random.default_rng(seed)
    nf = int(rng.integers(192, 640))
    nres = nf // 4
    counts = rng.integers(1, 5, size=nf)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    indices = rng.integers(0, nres, size=int(counts.sum())).astype(np.int64)
    cap = rng.integers(1, 9, size=nres).astype(np.float64)
    want = ralloc.vector_water_fill(indptr, indices, cap.copy())
    got = vector_water_fill_torch(indptr, indices, cap, device="cpu")
    assert got.tobytes() == want.tobytes()


def test_torch_water_fill_empty():
    empty = vector_water_fill_torch(np.zeros(1, dtype=np.int64),
                                    np.zeros(0, dtype=np.int64),
                                    np.zeros(0), device="cpu")
    assert empty.size == 0


def test_fold_matches_subtract_at():
    """The fold is `np.subtract.at` then `np.maximum(., 0)`: k sequential
    subtractions, which differ from k*m in the last bit; holds not taken
    change nothing."""
    rng = np.random.default_rng(0)
    rem = rng.uniform(0.0, 3.0, size=64)
    rem[:3] = [np.nan, -0.0, 0.0]
    idx = rng.integers(0, 64, size=400)
    m = 0.1
    held = rng.random(400) < 0.75
    want = rem.copy()
    np.subtract.at(want, idx[held], m)
    np.maximum(want, 0.0, out=want)
    got = subtract_holds_(torch.from_numpy(rem.copy()), torch.from_numpy(idx),
                          torch.from_numpy(held),
                          torch.tensor(m, dtype=torch.float64)).numpy()
    assert got.tobytes() == want.tobytes()
    cnt = np.bincount(idx[held], minlength=64)
    fused = np.maximum(rem - cnt * m, 0.0)
    assert fused.tobytes() != want.tobytes()


def test_torch_solver_in_a_simulator_run(monkeypatch):
    """`solver="jit"` with the port's solver in place of the reference's
    jit kernel: the event trace and finish times equal the numpy solver's
    (the array core routes components of >= 192 flows to it: a
    cluster-wide shuffle over 16 nodes beside rack-local waves)."""
    calls = []

    def port_solver(indptr, indices, cap):
        calls.append(indptr.size - 1)
        return vector_water_fill_torch(indptr, indices, cap, device="cpu")

    monkeypatch.setattr(ralloc, "vector_water_fill_jit", port_solver)
    results = {}
    for solver in ("numpy", "jit"):
        topo = lovelock_cluster(16, 1, accel_rate=1.0,
                                fabric=Fabric(rack_size=4))
        tasks = shuffle(topo, cpu_work_per_node=0.2, bytes_per_node=1.0,
                        tag="all") + list(pipelined_shuffle_waves(
                            topo, waves=3, tasks_per_node=2, jitter=0.35,
                            seed=7))
        res = topo.engine(backend="array", solver=solver).run(tasks)
        assert res.complete
        results[solver] = res
    assert calls and max(calls) >= 192
    assert results["jit"].events == results["numpy"].events
    assert results["jit"].finish_times == results["numpy"].finish_times
