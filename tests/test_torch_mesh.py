"""The port's meshes and sharded training on gloo ranks on localhost:
mesh construction and placements, data parallelism against one device
(tests/test_distributed.py:140-169 on the port), tensor and data
parallelism through `train_loop` against the single-device loop, the
checkpointer under a mesh, and the world-size check. Each multi-rank test
ends within 120 s or fails."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_ranks  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

LIMIT = 120        # seconds, for every multi-rank test
LOSS_RTOL = 1e-5   # float32 losses: the same sums in another order
FFN_RTOL = 1e-5    # float32 MoE outputs, as tests/test_torch_moe.py


def test_mesh_and_placements(tmp_path):
    for r in run_ranks(4, "rank_mesh_basics", tmp_path, timeout=LIMIT):
        assert r["desc"] == [["data", "model"], [2, 2]]
        assert r["axes"] == {"batch": ["data"], "model": ["model"],
                             "fsdp": ["data"]}
        assert r["placements"] == ["S(0)", "S(0)", "R", "S(1)"]
        assert r["local_shape"] == [2, 6, 4]
        assert r["cs"] == ["S(0)", "R"] and r["cs_equal"]
        assert r["gather_equal"] and r["is_dtensor"]
        assert r["replicate"] and r["shard"]
        assert r["elastic"] == [["data", "model"], [2, 2]]


@pytest.mark.parametrize("dtype,tol,steps", [("float32", LOSS_RTOL, 1),
                                             ("bfloat16", 0.02, 3)])
def test_dp_matches_single_device(tmp_path, dtype, tol, steps):
    """qwen3-32b smoke on a (4, 2) ("data", "model") mesh against one
    device, from the same params and batches: float32, one step, losses
    within 1e-5 relative and params after the step within 1e-4 of the
    largest |p|; bf16, three steps (two of the compared losses follow an
    update), each loss within the reference's 0.02
    (tests/test_distributed.py:168)."""
    res = run_ranks(8, "rank_gspmd_parity", tmp_path, "qwen3-32b", [4, 2],
                    ["data", "model"], steps, dtype == "float32",
                    timeout=LIMIT)
    for r in res:
        assert len(r["losses"]) == steps
        for a, b in zip(r["losses"], r["ref_losses"]):
            assert abs(a - b) <= tol * (abs(b) if dtype == "float32" else 1)
        if dtype == "float32":
            assert r["param_err"] < 1e-4, r


def test_tp_dp_steps_match_single_device(tmp_path):
    """lovelock-20m smoke, float32, a (2, 2) mesh: 3 steps within 1e-5
    relative of one device's, the params after them within 1e-4 of the
    largest |p|."""
    res = run_ranks(4, "rank_gspmd_parity", tmp_path, "lovelock-20m",
                    [2, 2], ["data", "model"], 3, True, timeout=LIMIT)
    for r in res:
        np.testing.assert_allclose(r["losses"], r["ref_losses"],
                                   rtol=LOSS_RTOL)
        assert r["param_err"] < 1e-4, r


@pytest.mark.parametrize("arch", [
    "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
    "rwkv6-7b", "llama-3.2-vision-90b", "whisper-large-v3"])
def test_every_family_on_a_mesh_matches_single_device(tmp_path, arch):
    """The MoE, Mamba-hybrid, RWKV6 and cross-attention families' smoke
    variants, float32, on a (2, 2) mesh: 2 steps within 1e-5 relative of
    one device's, the params within 1e-3 of the largest |p|: Adam's first
    steps move an element by about lr whatever its gradient's size, so an
    element whose gradient cancels to near 0 can move the other way under
    another summation order (jamba read 2.7e-4 when this was written). The
    VLM's gate is 1 and the cross-attention families get random extras, so
    their cross paths are live."""
    res = run_ranks(4, "rank_gspmd_parity", tmp_path, arch, [2, 2],
                    ["data", "model"], 2, True, timeout=LIMIT)
    for r in res:
        np.testing.assert_allclose(r["losses"], r["ref_losses"],
                                   rtol=LOSS_RTOL)
        assert r["param_err"] < 1e-3, r


@pytest.mark.parametrize("arch", [
    "llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
    "rwkv6-7b", "llama-3.2-vision-90b", "whisper-large-v3"])
def test_serving_on_a_mesh_matches_single_device(tmp_path, arch):
    """The MoE, Mamba-hybrid, RWKV6 and cross-attention families' smoke
    variants, float32, served on a (2, 2) mesh: a prefill of 8 x 16 tokens
    and 4 greedy decode steps, each logit row within 1e-5 of one device's
    largest |logit|, and the same tokens. The VLM's gate is 1 and the
    cross-attention families get random extras."""
    for r in run_ranks(4, "rank_serve_parity", tmp_path, arch, [2, 2],
                       ["data", "model"], timeout=LIMIT):
        assert len(r["errs"]) == 5 and max(r["errs"]) < LOSS_RTOL, r["errs"]
        assert r["tokens"] == r["ref_tokens"]


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_routes_with_overflow_on_a_mesh(tmp_path, dispatch):
    """Top-2 routing at capacity factor 0.5 (tokens overflow) on a (2, 2)
    mesh, the tokens split by rows over "data": each rank's (expert_ids,
    positions, kept) for its rows equal one device's and the reference's
    `_moe_route` on the same numpy inputs (positions counted over the
    whole batch), the outputs within 1e-5 and the load-balance losses
    within 1e-6 of one device's."""
    import jax.numpy as jnp
    from _torch_dist import moe_route_inputs
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro.models import layers as JL
    x, p = moe_route_inputs(0)
    B, S, D = x.shape
    _, ids, pos, C, _ = JL._moe_route(
        {"router": jnp.asarray(p["router"])}, jnp.asarray(x.reshape(-1, D)),
        JMoEConfig(num_experts=p["router"].shape[1], top_k=2,
                   d_ff=p["w_up"].shape[2], capacity_factor=0.5))
    want = {"ids": np.asarray(ids).tolist(), "pos": np.asarray(pos).tolist(),
            "kept": (np.asarray(pos) < C).tolist()}
    assert not all(k for row in want["kept"] for k in row)    # overflow
    rows = B * S // 2
    for r in run_ranks(4, "rank_moe_routes", tmp_path, 0, 2, 0.5, dispatch,
                       timeout=LIMIT):
        assert r["one_device"] == want
        sl = slice(r["row"] * rows, (r["row"] + 1) * rows)
        assert r["mesh"] == {k: v[sl] for k, v in want.items()}
        assert r["out_err"] < FFN_RTOL, r["out_err"]
        assert abs(r["aux"][0] - r["aux"][1]) <= 1e-6 * abs(r["aux"][1])


def test_train_loop_on_mesh_matches_single_device(tmp_path):
    """train_loop with data_mesh=2, model_mesh=2 on 4 ranks against the
    single-device train_loop (lovelock-20m smoke, float32, the same seed):
    losses within 1e-5 relative. Its checkpoints hold global tensors: the
    run resumed from its step-2 checkpoint repeats step 3's loss."""
    cfg = smoke_variant(get_config("lovelock-20m"))
    import dataclasses
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    _, want = ttrain.train_loop(cfg, steps=3, batch=4, seq=16, seed=3,
                                log_every=100, device="cpu")
    res = run_ranks(4, "rank_train_loop", tmp_path, str(tmp_path / "ck"),
                    3, 2, timeout=LIMIT)
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["resumed"], want["losses"][2:],
                                   rtol=LOSS_RTOL)
        assert r["step"] == 3


def test_train_loop_compressed_pod_on_three_axes(tmp_path):
    """train_loop with pod_mesh=2, data_mesh=2, model_mesh=2 and the int8
    pod sync on 8 ranks, against the single-device loop (lovelock-20m
    smoke, float32, the same seed): losses within the reference's 0.05
    (tests/test_distributed.py:118)."""
    cfg = smoke_variant(get_config("lovelock-20m"))
    import dataclasses
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    _, want = ttrain.train_loop(cfg, steps=3, batch=8, seq=16, seed=3,
                                log_every=100, device="cpu")
    for losses in run_ranks(8, "rank_train_loop_compressed", tmp_path, 3,
                            timeout=LIMIT):
        assert len(losses) == 3
        for a, b in zip(losses, want["losses"]):
            assert abs(a - b) < 0.05, (losses, want["losses"])


def test_checkpoint_under_mesh(tmp_path):
    """A state placed on a (2, 2) mesh saved and restored: every leaf's
    global tensor bit for bit, each restored leaf in the `like` leaf's
    placements, the manifest the one a meshless save of the same state
    writes, and at most `buffers` chunks in flight (a chunk is at least a
    row)."""
    res = run_ranks(4, "rank_checkpoint", tmp_path, str(tmp_path / "ck"),
                    4096, timeout=LIMIT)
    for r in res:
        assert r["same"] and all(r["same"].values()), r["same"]
        assert any(k.startswith("ef/") for k in r["same"])
        assert r["placements_kept"] and all(r["placements_kept"].values())
    assert res[0]["manifests_equal"]
    assert 0 < res[0]["peak"] <= res[0]["bound"]


def test_train_loop_raises_on_world_size_mismatch(tmp_path):
    """A 2 x 2 mesh on 2 ranks raises, naming the world size found."""
    for msg in run_ranks(2, "rank_train_loop_mismatch", tmp_path, 2, 2,
                         timeout=LIMIT):
        assert msg and "4 ranks" in msg and "world size 2" in msg, msg


@pytest.mark.parametrize("kw", [{"data_mesh": 2}, {"model_mesh": 2},
                                {"pod_mesh": 2}])
def test_train_loop_needs_a_process_group(kw):
    """Without a process group a mesh of more than one rank raises (world
    size 1); it never trains on one device instead."""
    cfg = smoke_variant(get_config("lovelock-20m"))
    with pytest.raises(RuntimeError, match="world size 1"):
        ttrain.train_loop(cfg, steps=1, batch=4, seq=8, device="cpu", **kw)
