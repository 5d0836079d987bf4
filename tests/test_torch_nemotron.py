"""The port's Nemotron-H path (nemotron-3-nano-30b-a3b): blocks of one mixer
each from a layer pattern, the Mamba-2 mixer and its chunked scan, the
sigmoid router with a correction bias, relu² experts and the wider shared
expert, against the benchmark's plain float32 reference
(`portbench/reference/nemotron_h.py`, loaded by its path: the JAX package
has no Nemotron-H), on seeded weights at a small size, float32."""
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import (MambaConfig, ModelConfig,  # noqa: E402
                                      MoEConfig)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train.steps import make_prefill, make_serve_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the reference shares the control's helpers with portbench's decoder.py
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))
_spec = importlib.util.spec_from_file_location(
    "nemotron_h_reference", ROOT / "portbench" / "reference" / "nemotron_h.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

# float32 on both sides: the chunked scan and the recurrence, the batched
# and the per-expert MoE, round in different orders (2e-7 measured)
TOL = 1e-5
MODEL = {"name": "tiny-nemotron", "family": "hybrid", "num_layers": 8,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "d_ff": 32, "vocab_size": 256, "norm_eps": 1e-5,
         "tie_embeddings": False, "layer_pattern": "MEM*EME*",
         "use_rope": False,
         "mamba": {"d_state": 8, "d_conv": 4, "expand": 2, "n_heads": 4,
                   "head_dim": 8, "n_groups": 2, "chunk": 4},
         "moe": {"num_experts": 8, "top_k": 2, "d_ff": 16,
                 "capacity_factor": 1.25, "num_shared_experts": 1,
                 "shared_d_ff": 32, "router": "sigmoid_bias",
                 "activation": "relu2", "routed_scaling": 2.5,
                 "dispatch": "scatter"},
         "param_dtype": "float32", "compute_dtype": "float32"}


def _cfg(m=MODEL) -> ModelConfig:
    """The program's config of a configuration's `model`, as the benchmark
    makes it."""
    return ModelConfig(**{**m, "moe": MoEConfig(**m["moe"]),
                          "mamba": MambaConfig(**m["mamba"])})


def _serve(cfg, params, prompts, gen):
    """Prefill, then gen - 1 greedy decode steps through float32 caches:
    (tokens (B, gen), the logits each was chosen from (B, gen, Vp))."""
    B, P = prompts.shape
    caches = M.init_caches(cfg, B, P + gen, dtype=torch.float32,
                           device="cpu")
    with torch.no_grad():
        logits, caches = make_prefill(cfg)(params, caches,
                                           {"tokens": prompts})
        tok = logits[:, -1].argmax(-1)[:, None]
        toks, picked = [tok], [logits[:, -1]]
        step = make_serve_step(cfg)
        for _ in range(gen - 1):
            tok, caches, last = step(params, caches, tok)
            toks.append(tok)
            picked.append(last)
    return torch.cat(toks, 1), torch.stack(picked, 1)


@pytest.mark.parametrize("P", [11, 16], ids=["ragged", "whole_chunks"])
def test_prefill_and_decode_match_reference_forward(P):
    """Prefill and decode through the caches (KV for '*', conv and SSM
    states for 'M', nothing for 'E') give the logits of the reference's
    full forward over the prompt and the served tokens."""
    params = ref.make_params(MODEL, P, "cpu")
    prompts = torch.randint(0, 256, (3, P),
                            generator=torch.Generator().manual_seed(P))
    served, logits = _serve(_cfg(), params, prompts, 6)
    want = ref.served_logits(params, MODEL, prompts, served)
    torch.testing.assert_close(logits[..., :256], want, atol=TOL, rtol=0)
    assert want.abs().max() > 0.1


def _scan_inputs(seed, S, H=4, P=8, G=2, N=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, S, H, P, generator=g),
            torch.rand(2, S, H, generator=g) * 0.5,
            -torch.arange(1.0, H + 1),
            torch.randn(2, S, G, N, generator=g),
            torch.randn(2, S, G, N, generator=g),
            torch.randn(2, H, P, N, generator=g))


@pytest.mark.parametrize("S,chunk", [(11, 4), (64, 16), (1, 4)])
def test_chunked_scan_matches_recurrence(S, chunk):
    """`mamba2_chunked` from a nonzero state, over a ragged last chunk,
    several whole chunks and a single token, against the recurrence
    written token by token: every output and the last state."""
    x, dt, A, Bm, Cm, h0 = _scan_inputs(S, S)
    y, hT = L.mamba2_chunked(x, dt, A, Bm, Cm, h0, chunk)
    h, ys = h0, []
    for t in range(S):
        Bh = Bm[:, t].repeat_interleave(2, dim=1)            # (B,H,N)
        Ch = Cm[:, t].repeat_interleave(2, dim=1)
        h = (torch.exp(dt[:, t] * A)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, :, None])
        ys.append((h * Ch[:, :, None]).sum(-1))
    torch.testing.assert_close(y, torch.stack(ys, 1), atol=TOL, rtol=0)
    torch.testing.assert_close(hT, h, atol=TOL, rtol=0)


def _moe_case(capacity_factor=1.25, bias=0.5):
    cfg = MoEConfig(**{**MODEL["moe"], "capacity_factor": capacity_factor})
    g = torch.Generator().manual_seed(7)
    D, E, Fe, Fs = 64, cfg.num_experts, cfg.d_ff, cfg.shared_d_ff
    p = {"router": torch.randn(D, E, generator=g) * 0.3,
         "router_bias": torch.randn(E, generator=g) * bias,
         "w_up": torch.randn(E, D, Fe, generator=g) / D ** 0.5,
         "w_down": torch.randn(E, Fe, D, generator=g) / Fe ** 0.5,
         "shared": {"w_up": torch.randn(D, Fs, generator=g) / D ** 0.5,
                    "w_down": torch.randn(Fs, D, generator=g) / Fs ** 0.5}}
    return cfg, p, torch.randn(2, 12, D, generator=g)


def test_sigmoid_bias_router_chooses_by_bias_and_gates_by_score():
    """The correction bias changes the choices from the plain top-k of the
    sigmoid scores; the gates are the chosen scores over their sum, times
    2.5, and sum to 2.5 where nothing is dropped."""
    cfg, p, x = _moe_case(capacity_factor=8.0)
    xt = x.reshape(-1, 64)
    gates, ids, _, _, probs = L._moe_route(p, xt, cfg)
    plain = torch.topk(probs, cfg.top_k, dim=-1)[1]
    assert torch.equal(probs, torch.sigmoid(xt @ p["router"]))
    assert not torch.equal(ids.sort(-1)[0], plain.sort(-1)[0])
    assert torch.equal(ids, torch.topk(probs + p["router_bias"],
                                       cfg.top_k, dim=-1)[1])
    chosen = probs.gather(-1, ids)
    torch.testing.assert_close(gates, 2.5 * chosen / chosen.sum(-1,
                                                                keepdim=True))
    torch.testing.assert_close(gates.sum(-1), torch.full((24,), 2.5))


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_block_matches_reference(dispatch):
    """The MoE block (sigmoid router with its bias, relu² experts without
    a gate leaf, a shared expert twice an expert's width, capacity drops)
    against the reference's, on the same weights, by both dispatches."""
    cfg, p, x = _moe_case()
    cfg = dataclasses.replace(cfg, dispatch=dispatch)
    out, _ = L.moe_ffn(p, x, cfg)
    gates = L._moe_route(p, x.reshape(-1, 64), cfg)[0]
    assert (gates == 0).any()                   # some choices dropped
    want = ref.moe(p, x, MODEL, ref.Ops(), [(0, 12)])
    torch.testing.assert_close(out, want, atol=TOL, rtol=0)
    shared = ref.relu2(x.reshape(-1, 64), p["shared"]["w_up"],
                       p["shared"]["w_down"], ref.Ops())
    assert (out.reshape(-1, 64) - shared).abs().max() > 0.1


def test_param_count_equals_the_tree():
    """param_count() is the size of the program's tree (every leaf, norms
    and biases too), at a small size and, by the reference's layout, at
    the published one: 31,577,940,288, 3,580,076,352 active."""
    cfg = _cfg()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert cfg.param_count()[0] == sum(t.numel()
                                       for t in tree_leaves(params))
    full = get_config("nemotron-3-nano-30b-a3b")
    m = dict(ref_model(full))
    assert full.param_count() == (31_577_940_288, 3_580_076_352)
    assert sum(torch.Size(s).numel() for _, s, _, _ in ref.layout(m)) == \
        full.param_count()[0]


def ref_model(cfg: ModelConfig) -> dict:
    """A config as a configuration file's `model`."""
    return {**dataclasses.asdict(cfg), "moe": dataclasses.asdict(cfg.moe),
            "mamba": dataclasses.asdict(cfg.mamba)}


def test_init_params_match_reference_layout():
    """The program's tree and the reference's layout hold the same leaves
    at the same shapes and dtypes, and the caches hold KV for '*' blocks,
    conv and SSM states for 'M' blocks and nothing for 'E' blocks."""
    cfg = _cfg()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)

    def walk(t, pre=()):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from walk(v, pre + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from walk(v, pre + (i,))
        else:
            yield pre, tuple(t.shape), t.dtype
    assert sorted(walk(params), key=str) == sorted(
        ((p, s, d) for p, s, d, _ in ref.layout(MODEL)), key=str)
    caches = M.init_caches(cfg, 2, 20, device="cpu")["layers"]
    kinds = [set(c) for c in caches]
    assert kinds == [{"mamba"} if k == "M" else {"kv"} if k == "*" else set()
                     for k in MODEL["layer_pattern"]]
    assert caches[0]["mamba"]["ssm"].shape == (1, 2, 4, 8, 8)
    assert caches[0]["mamba"]["conv"].shape == (1, 2, 3, 32 + 2 * 2 * 8)


def test_blocks_from_the_pattern_have_no_sharded_path():
    """A layer pattern's blocks under sharding rules stop with a clear
    error rather than run unsharded."""
    cfg = _cfg()
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    specs = M.block_specs(cfg)
    assert M.period_of(cfg) == 8 and [s["kind"] for s in specs[:4]] == [
        "mamba2", "moe", "mamba2", "attn"]
    with pytest.raises(NotImplementedError, match="sharded"):
        M._apply_block(M._at(params["layers"][0], 0), specs[0],
                       torch.zeros(1, 4, 64), cfg, rules=object())


def test_mamba2_heads_need_a_pattern():
    """The pattern alone selects Mamba-2: Mamba-2 heads without one stop
    with a clear error rather than run Mamba-1."""
    cfg = dataclasses.replace(_cfg(), layer_pattern="", attn_every=2)
    with pytest.raises(ValueError, match="layer_pattern"):
        M.block_specs(cfg)


def test_spans_and_counters():
    """Traced: a `model.mamba2` span around each Mamba-2 mixer with its
    `model.mamba2.scan` (tokens, chunks; 0 chunks at a decode step), the
    MoE's spans with `model.moe.shared`, and `moe.choices` = N x K a
    route."""
    params = ref.make_params(MODEL, 1, "cpu")
    prompts = torch.randint(0, 256, (2, 10),
                            generator=torch.Generator().manual_seed(1))
    obs.drain()
    obs.enable()
    try:
        _serve(_cfg(), params, prompts, 3)
    finally:
        obs.disable()
    recs = obs.drain()
    by_id = {r["id"]: r for r in recs}
    scans = [r for r in recs if r["name"] == "model.mamba2.scan"]
    assert len(scans) == 3 * 3                  # 3 blocks, 3 forwards
    assert all(by_id[r["parent"]]["name"] == "model.mamba2" for r in scans)
    assert sorted({(r["attrs"]["tokens"], r["attrs"]["chunks"])
                   for r in scans}) == [(2, 0), (20, 3)]
    routes = [r for r in recs if r["name"] == "model.moe.route"]
    assert sorted(r["counts"]["moe.choices"] for r in routes) == \
        [4] * 6 + [40] * 3
    assert sum(r["name"] == "model.moe.shared" for r in recs) == 9


def test_serve_cli_runs_the_smoke_variant(monkeypatch, capsys):
    """`--smoke` of the registered config: a small layer pattern on the
    CPU through the serve entry point."""
    from repro_torch.launch import serve as tserve
    small = smoke_variant(get_config("nemotron-3-nano-30b-a3b"))
    assert small.layer_pattern == "MEM*EME*" and small.num_layers == 8
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "nemotron-3-nano-30b-a3b", "--smoke", "--device",
        "cpu", "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    tserve.main()
    assert "generated shape: (2, 3)" in capsys.readouterr().out
