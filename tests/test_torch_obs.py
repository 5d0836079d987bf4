"""The port's spans and counters (`repro_torch.obs`): off, nothing is kept
and nothing extra is computed; on, `serve` and a train step make the
span tree that the benchmark's readers read, the MoE counters equal a
plain count of the routes, and the outputs do not move."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.adamw import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

B, P, G = 2, 16, 4


@pytest.fixture
def tracing():
    """Tracing on for the test, then off with nothing left recorded."""
    obs.drain()
    obs.enable()
    yield
    obs.disable()
    obs.drain()


def _hybrid():
    return smoke_variant(get_config("jamba-v0.1-52b"))


def _serve(cfg, seed=0):
    return serve(cfg, batch=B, prompt_len=P, gen=G, seed=seed, device="cpu")


def _train(cfg, steps=1, remat=True):
    """`steps` train steps from seed 0's weights: (losses, state)."""
    params = M.init_params(torch.Generator().manual_seed(0), cfg, tp=1)
    state = adamw_init(params, OptimizerConfig())
    step = make_train_step(cfg, OptimizerConfig(), remat=remat)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(steps):
        tokens = torch.randint(0, cfg.vocab_size, (B, P + 1), generator=gen)
        state, met = step(state, {"tokens": tokens[:, :-1],
                                  "labels": tokens[:, 1:]})
        losses.append(met["loss"])
    return losses, state


def _ancestors(rec, by_id):
    out = []
    while rec["parent"] is not None:
        rec = by_id[rec["parent"]]
        out.append(rec["name"])
    return out


def test_off_keeps_nothing_and_makes_no_event(monkeypatch):
    """Off, a span is the shared no-op context: no record, no CUDA event,
    no counter tensor, whatever the device."""
    obs.disable()
    obs.drain()

    def refuse(*a, **k):
        raise AssertionError("called while tracing is off")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(obs, "count", refuse)
    assert obs.span("a", x=1) is obs.span("b")
    cfg = _hybrid()
    _serve(cfg)
    _train(cfg)
    assert obs.drain() == [] and obs._pool == []


class _FakeEvent:
    """A CUDA event on a made-up clock: each record is 1 ms later."""
    made = 0
    clock = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.t = None

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA in use as far as `obs` can tell, with made-up events, a pool
    of 4 and tracing on."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(obs, "POOL", 4)
    monkeypatch.setattr(obs, "_pool", [])
    monkeypatch.setattr(_FakeEvent, "made", 0)
    obs.drain()
    obs.enable()
    yield
    obs.disable()
    obs.drain()


def test_timed_spans_take_events_from_the_pool(fake_cuda):
    """`enable` makes the pool; a timed span takes two of its events and
    makes none until it runs out; an untimed span takes none; `drain`
    reads the events and gives them back."""
    assert _FakeEvent.made == 4 and len(obs._pool) == 4
    with obs.span("a", timed=True):
        with obs.span("b"):
            with obs.span("c", timed=True):
                pass
    assert _FakeEvent.made == 4 and obs._pool == []
    with obs.span("d", timed=True):        # the pool is empty: 4 more
        pass
    assert _FakeEvent.made == 8 and len(obs._pool) == 2
    a, b, c, d = obs.drain()
    assert len(obs._pool) == 8 and _FakeEvent.made == 8
    assert b["device_s"] is None
    # records a, c, c, a: 3 ms and 1 ms apart
    assert (a["device_s"], c["device_s"], d["device_s"]) == (
        3e-3, 1e-3, 1e-3)
    assert obs.seconds(a) == 3e-3


def test_only_the_spans_a_metric_reads_are_timed(fake_cuda):
    """On the card, only the spans whose device seconds a benchmark metric
    reads record events; the others name the host's time only."""
    cfg = _hybrid()
    _serve(cfg)
    _train(cfg)
    timed = {r["name"] for r in obs.drain() if r["device_s"] is not None}
    assert timed == {"model.mamba.scan", "model.moe", "model.moe.route",
                     "model.moe.experts", "train.backward",
                     "train.optimizer"}


def test_records_nest_count_and_close_on_exceptions(tracing):
    with obs.span("outer", batch=7):
        obs.count("n", 2)
        with obs.span("inner", k="v"):
            obs.count("n", torch.tensor(3))
            obs.count("n", 4)
        with pytest.raises(ValueError):
            with obs.span("failed"):
                raise ValueError
    obs.count("n", 100)                 # no span open: nothing
    outer, inner, failed = obs.drain()
    assert [r["name"] for r in (outer, inner, failed)] == [
        "outer", "inner", "failed"]
    assert outer["parent"] is None
    assert inner["parent"] == failed["parent"] == outer["id"]
    assert {r["batch"] for r in (outer, inner, failed)} == {7}
    assert inner["attrs"] == {"k": "v"} and inner["counts"] == {"n": 7}
    assert outer["counts"] == {"n": 2} and failed["counts"] == {}
    assert all(r["device_s"] is None and r["end_ns"] >= r["start_ns"]
               for r in (outer, inner, failed))
    assert obs.seconds(outer) == (outer["end_ns"] - outer["start_ns"]) / 1e9
    assert obs.drain() == []


def test_serve_span_tree(tracing):
    """Two `serve` calls: a batch span each, with its own id, around its
    prefill and decode steps; the blocks' spans below them, every record
    carrying its call's batch id."""
    cfg = _hybrid()
    _serve(cfg)
    _serve(cfg, seed=1)
    recs = obs.drain()
    by_id = {r["id"]: r for r in recs}
    batches = [r for r in recs if r["name"] == "serve.batch"]
    assert len(batches) == 2 and batches[0]["batch"] != batches[1]["batch"]
    for b in batches:
        assert b["parent"] is None
        assert b["attrs"] == {"B": B, "prompt_len": P, "gen": G}
        kids = [r for r in recs if r["parent"] == b["id"]]
        assert [r["name"] for r in kids] == (["serve.prefill"]
                                             + ["serve.decode_step"] * (G - 1))
        assert [r["attrs"]["step"] for r in kids[1:]] == list(range(G - 1))
    for r in recs:
        top = by_id[r["id"]]
        while top["parent"] is not None:
            top = by_id[top["parent"]]
        assert top["name"] == "serve.batch" and r["batch"] == top["batch"]
    parent = {"model.mamba.scan": "model.mamba",
              "model.moe.route": "model.moe",
              "model.moe.experts": "model.moe"}
    for r in recs:
        if r["name"] in parent:
            assert by_id[r["parent"]]["name"] == parent[r["name"]]
        if r["name"] in ("model.mamba", "model.moe"):
            assert by_id[r["parent"]]["name"] in ("serve.prefill",
                                                  "serve.decode_step")
    # a call: 7 Mamba and 4 MoE blocks (one period) in each of G forwards
    n = {k: sum(r["name"] == k for r in recs) for k in parent}
    assert n == {"model.mamba.scan": 2 * G * 7, "model.moe.route": 2 * G * 4,
                 "model.moe.experts": 2 * G * 4}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_step_span_tree(tracing, remat):
    """A step's span around its forward, backward and optimizer; under
    remat the periods' recomputed forward nests in the backward."""
    cfg = _hybrid()
    _train(cfg, steps=2, remat=remat)
    recs = obs.drain()
    by_id = {r["id"]: r for r in recs}
    steps = [r for r in recs if r["name"] == "train.step"]
    assert [r["attrs"]["step"] for r in steps] == [0, 1]
    for s in steps:
        assert s["parent"] is None and s["batch"] is None
        kids = [r["name"] for r in recs if r["parent"] == s["id"]]
        assert kids == ["train.forward", "train.backward", "train.optimizer"]
    where = {}
    for r in recs:
        if r["name"] == "model.mamba":
            up = _ancestors(r, by_id)
            assert up[-1] == "train.step"
            where[up[0]] = where.get(up[0], 0) + 1
    # 7 Mamba blocks a forward; the recompute runs them all again
    assert where == ({"train.forward": 14, "train.backward": 14} if remat
                     else {"train.forward": 14})


@pytest.mark.parametrize("N,S", [(2, 16), (4, 1)], ids=["prefill", "decode"])
def test_moe_counters_match_a_plain_count(tracing, N, S):
    """`moe.choices`, `moe.kept`, `moe.slots` and `moe.experts_hit` of a
    route, against a count of `_moe_route`'s own outputs: at prefill, and
    at a decode step of 4 rows, where 16 experts, top-2, give capacity
    1."""
    E, K, D, F = 16, 2, 32, 16
    cfg = MoEConfig(num_experts=E, top_k=K, d_ff=F, capacity_factor=1.25)
    g = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(D, E, generator=g),
         "w_gate": torch.randn(E, D, F, generator=g) / D ** 0.5,
         "w_up": torch.randn(E, D, F, generator=g) / D ** 0.5,
         "w_down": torch.randn(E, F, D, generator=g) / F ** 0.5}
    x = torch.randn(N, S, D, generator=g)
    L.moe_ffn(p, x, cfg)
    # nothing is counted before the records are drained
    (pending,) = [s.rec["counts"] for s in obs._spans
                  if s.rec["name"] == "model.moe.route"]
    assert pending["moe.slots"] == [E * _capacity(cfg, N * S)]
    assert all(callable(v) for k in ("moe.kept", "moe.experts_hit")
               for v in pending[k])
    (route,) = [r for r in obs.drain() if r["name"] == "model.moe.route"]
    obs.disable()
    gate, ids, _, C, _ = L._moe_route(p, x.reshape(N * S, D), cfg)
    assert C == _capacity(cfg, N * S) == max(1, int(1.25 * K * N * S / E))
    if S == 1:
        assert C == 1
    kept = gate > 0
    assert route["attrs"] == {"experts": E}
    assert route["counts"] == {
        "moe.choices": N * S * K, "moe.kept": int(kept.sum()),
        "moe.slots": E * C,
        "moe.experts_hit": len(set(ids[kept].tolist()))}


def _capacity(cfg, n):
    return max(1, int(cfg.capacity_factor * cfg.top_k * n
                      / cfg.num_experts))


def test_outputs_equal_with_tracing_on_and_off():
    """Served tokens and logits, the train losses and the weights after
    two steps: bitwise the same with tracing on and off."""
    cfg = _hybrid()
    obs.disable()
    toks, _, logits = _serve(cfg)
    losses, state = _train(cfg, steps=2)
    obs.enable()
    try:
        toks_on, _, logits_on = _serve(cfg)
        losses_on, state_on = _train(cfg, steps=2)
    finally:
        obs.disable()
    assert obs.drain()
    assert torch.equal(toks, toks_on) and torch.equal(logits, logits_on)
    assert all(torch.equal(a, b) for a, b in zip(losses, losses_on))
    flat = [t for _, t in sorted(_named(state.params))]
    flat_on = [t for _, t in sorted(_named(state_on.params))]
    assert len(flat) == len(flat_on) and all(
        torch.equal(a, b) for a, b in zip(flat, flat_on))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
