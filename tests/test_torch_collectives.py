"""The port's collectives (`repro_torch.core.collectives`) on gloo ranks on
localhost: flat and hierarchical all-reduce against the numpy sum and
against each other's cross-pod bytes; the quantized pod sum bit for bit
against a numpy re-enactment of the reference's math
(src/repro/core/collectives.py:43-53); the error-feedback properties of
tests/test_distributed.py:49-85; the compressed train step against gspmd
(tests/test_distributed.py:88-119); and the traffic model against the
reference's. Each multi-rank test ends within 120 s or fails."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import quantized_psum_np, run_ranks  # noqa: E402
from repro.core import collectives as JC  # noqa: E402
from repro_torch.core import collectives as TC  # noqa: E402

LIMIT = 120        # seconds, for every multi-rank test


def test_flat_equals_hierarchical_equals_sum(tmp_path):
    """(2, 2, 2) mesh, 4 replicas of 64: both schedules give the numpy sum
    on every rank; hierarchical hands the pod-spanning group 1/|data| of
    the bytes flat hands it."""
    R, N = 4, 64
    x = np.random.default_rng(0).standard_normal((R, N), np.float32)
    res = run_ranks(8, "rank_all_reduce", tmp_path, R, N, timeout=LIMIT)
    for r in res:
        for name in ("flat", "hierarchical"):
            assert r[name]["shape"] == [1, N]
            np.testing.assert_allclose(r[name]["sum"][0], x.sum(0),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["flat"]["sum"], r["hierarchical"]["sum"],
                                   rtol=1e-5, atol=1e-6)
        assert r["flat"]["cross_pod_bytes"] == N * 4
        assert r["hierarchical"]["cross_pod_bytes"] == N * 4 // 2


@pytest.mark.parametrize("ef_dtype", ["float32", "bfloat16"])
def test_quantized_psum_bit_equal_to_numpy(tmp_path, ef_dtype):
    """(2, 4) ("pod", "data") mesh: every rank's mean and new ef, from a
    whole-leaf tensor and from a DTensor split over the data ranks (the
    scale the max over the whole leaf on both pods), equal the numpy
    re-enactment bit for bit."""
    from _torch_dist import _np_inputs
    g, e = _np_inputs(7, (2, 256), 0.05)
    bf16 = ef_dtype == "bfloat16"
    if bf16:
        from _torch_dist import bf16_round
        e = bf16_round(e)
    want, want_efs = quantized_psum_np([g[0], g[1]], [e[0], e[1]],
                                       ef_bf16=bf16)
    res = run_ranks(8, "rank_quantized_psum", tmp_path, 7, ef_dtype,
                    timeout=LIMIT)
    for rank, r in enumerate(res):
        pod = rank // 4
        for case in ("plain", "dtensor"):
            out, new_ef, dt = r[case]
            assert dt == f"torch.{ef_dtype}"
            np.testing.assert_array_equal(np.float32(out), want)
            np.testing.assert_array_equal(np.float32(new_ef), want_efs[pod])
    assert np.abs(want_efs[0]).max() > 0


def test_quantized_psum_error_feedback(tmp_path):
    """As tests/test_distributed.py:49-85: one sync is off the true mean
    by at most the scale; with the error fed back, 20 syncs of the same
    gradient drift from the true sum by < 1% of it."""
    for r in run_ranks(8, "rank_error_feedback", tmp_path, 0, 20,
                       timeout=LIMIT):
        assert r["err1"] <= r["scale"], r
        assert r["rel"] < 0.01, r


def test_compressed_pod_step_matches_gspmd(tmp_path):
    """As tests/test_distributed.py:88-119 on the port: h2o-danube-1.8b
    smoke, bf16, a (2, 2, 2) mesh, 3 steps of each sync from the same
    params and batches: losses within 0.05; the ef finite and nonzero."""
    res = run_ranks(8, "rank_compressed_vs_gspmd", tmp_path,
                    "h2o-danube-1.8b", 3, 8, 16, timeout=LIMIT)
    for r in res:
        assert r == res[0]                      # every rank agrees
    r = res[0]
    for a, b in zip(r["gspmd"], r["compressed_pod"]):
        assert np.isfinite(a) and np.isfinite(b)
        assert abs(a - b) < 0.05, r
    assert r["ef_finite"] and r["ef_max"] > 0


def test_compressed_pod_sync_is_identity_without_pod(tmp_path):
    """compressed_pod_sync on a mesh with no pod axis returns its inputs;
    the traffic model's numbers are the reference's."""
    class NoPod:
        mesh_dim_names = ("data", "model")
    g, e = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    assert TC.compressed_pod_sync(g, e, NoPod()) == (g, e)
    for sched in ("flat", "hierarchical", "compressed"):
        for n_pods, data in ((1, 16), (2, 16), (4, 8)):
            assert TC.allreduce_traffic_model(
                1 << 20, n_pods=n_pods, data=data, schedule=sched) == \
                JC.allreduce_traffic_model(1 << 20, n_pods=n_pods, data=data,
                                           schedule=sched)
            assert TC.CollectiveTrafficComponent(sched).phases(
                1e6, n_pods=n_pods, data=data) == \
                JC.CollectiveTrafficComponent(sched).phases(
                    1e6, n_pods=n_pods, data=data)
    assert TC.phi_traffic_scaling(1000, 4) == JC.phi_traffic_scaling(1000, 4)
    with pytest.raises(ValueError):
        TC.allreduce_traffic_model(1, n_pods=1, data=1, schedule="ring")
