"""The port's cross-attention families against `repro`, on the same numpy
inputs: `cross_attention`, whisper's `_sinusoid` and `_run_encoder`, and
the llama-3.2-vision-90b and whisper-large-v3 smoke models (forward,
prefill + decode, a train step, serve). Float32 throughout unless a test
says otherwise.

The VLM's cross-attention gate starts at 0 (tanh(0) = 0: the layer adds
nothing), and zero image embeddings or audio frames make k = v = 0: either
would let a wrong cross-attention pass. So every test here sets the gate
to GATE on both sides and feeds random extras.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (KERNEL_TOL, LOGIT_TOL_BF16,  # noqa: E402
                           LOGIT_TOL_F32, cfg_pair, jax_to_torch, to_np)
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.steps import (  # noqa: E402
    cross_entropy as jax_cross_entropy, make_prefill as jax_make_prefill,
    make_serve_step as jax_make_serve_step)
from repro_torch.convert import (caches_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.steps import make_grad_fn  # noqa: E402

VLM, WHISPER = "llama-3.2-vision-90b", "whisper-large-v3"
ARCHS = [VLM, WHISPER]
GATE = 1.0                 # the VLM's cross-attention gate in these tests
LOSS_RTOL = 1e-5           # float32 losses, as tests/test_torch_train.py
# float32 gradients of the two packages: each leaf's largest difference
# over its largest |g| (the sums run in other orders; ~1e-6 in practice)
GRAD_RTOL = 1e-5
LIVE_FACTOR = 20


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _extra(cfg, seed, B):
    """Random N(0,1) float32 image embeddings (VLM) or audio frames
    (whisper), (B, T, D) with the config's T."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_layers:
        T, key = cfg.num_audio_frames, "audio_frames"
    else:
        T, key = cfg.num_image_tokens, "image_embeds"
    return {key: rng.standard_normal((B, T, cfg.d_model), np.float32)}


def _jx(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _tx(extra):
    return {k: torch.from_numpy(v) for k, v in extra.items()}


def _with_gate(jparams, cfg, gate):
    """The reference's params with every VLM gate set to `gate`."""
    if not cfg.cross_attn_every:
        return jparams
    layers = list(jparams["layers"])
    for i, spec in enumerate(JM.block_specs(cfg)):
        if spec["kind"] == "xattn":
            attn = dict(layers[i]["attn"])
            attn["gate"] = jnp.full_like(attn["gate"], gate)
            layers[i] = {**layers[i], "attn": attn}
    return {**jparams, "layers": layers}


@functools.cache
def _setup(arch, f32=True, gate=GATE):
    """Config pair and the reference's params (gate set), and the port's
    converted copy (read-only in the tests)."""
    jc, tc = cfg_pair(arch, smoke=True, f32=f32)
    jparams = _with_gate(_jax_init(jax.random.PRNGKey(0), jc), jc, gate)
    return jc, tc, jparams, jax_to_torch(jparams)


_jax_init = jax.jit(JM.init_params, static_argnums=(1, 2))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _xattn_inputs(seed, B, S, T, D, H, K, hd, gate):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.2
    p = {"wq": w(D, H, hd), "wk": w(D, K, hd), "wv": w(D, K, hd),
         "wo": w(H, hd, D), "qn": w(hd), "kn": w(hd)}
    if gate is not None:
        p["gate"] = np.array(gate, np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    src = rng.standard_normal((B, T, D)).astype(np.float32)
    cache = {"k": w(B, T, K, hd) * 5, "v": w(B, T, K, hd) * 5}
    return p, x, src, cache


@pytest.mark.parametrize("gate", [0.7, None], ids=["gated", "ungated"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_cross_attention_matches_reference(form, qk_norm, gate):
    """Prefill form (k, v projected from the source and returned) and
    decode form (one query over a given {k, v}), GQA 4/2, to 2e-5."""
    jc, tc = cfg_pair(VLM, smoke=True, qk_norm=qk_norm)
    S = 7 if form == "prefill" else 1
    p, x, src, cache = _xattn_inputs(3, 2, S, 11, 64, 4, 2, 16, gate)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    if form == "prefill":
        want, wc = JL.cross_attention(jp, x, jc, kv=src)
        got, gc = TL.cross_attention(tp, torch.from_numpy(x), tc,
                                     kv=torch.from_numpy(src))
    else:
        want, wc = JL.cross_attention(jp, x, jc,
                                      cache=jax.tree.map(jnp.asarray, cache))
        got, gc = TL.cross_attention(tp, torch.from_numpy(x), tc,
                                     cache=jax.tree.map(torch.from_numpy,
                                                        cache))
    np.testing.assert_allclose(to_np(got), to_np(want),
                               atol=KERNEL_TOL["float32"], rtol=0)
    for n in ("k", "v"):
        np.testing.assert_allclose(to_np(gc[n]), to_np(wc[n]),
                                   atol=KERNEL_TOL["float32"], rtol=0)
    assert float(np.abs(to_np(got)).max()) > 0.1       # not a dead layer


@pytest.mark.parametrize("T,D", [(16, 64), (1500, 1280)])
def test_sinusoid_matches_reference(T, D):
    """whisper's absolute positions, at smoke size and at its 1500 frames
    by 1280: the angle pos / 10000^(2i/D) may round one float32 ulp apart
    in the two packages (their pow differs in the last bit), which moves a
    sine or cosine by at most that ulp of the largest angle, T - 1. The
    decode form (one position, `start`) equals the table's row."""
    want = to_np(JM._sinusoid(T, D))
    got = TM._sinusoid(T, D, "cpu")
    assert got.dtype == torch.float32 and got.shape == (T, D)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=float(np.spacing(np.float32(T - 1))))
    for t in (0, 5, T - 1):
        np.testing.assert_array_equal(
            to_np(TM._sinusoid(1, D, "cpu", start=t)[0]), to_np(got[t]))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_run_encoder_matches_reference(use_kernels):
    """whisper's encoder (smoke: 2 layers, 16 frames): non-causal blocks
    without rope, then its final norm, to 2e-5. The reference runs its
    plain attention on the CPU, as its own tests do."""
    jc, tc, jparams, tparams = _setup(WHISPER)
    frames = _extra(jc, 4, 2)["audio_frames"]
    want = JM._run_encoder(jparams, jc, jnp.asarray(frames), None)
    got = TM._run_encoder(tparams, tc, torch.from_numpy(frames),
                          use_kernels=use_kernels)
    np.testing.assert_allclose(to_np(got), to_np(want),
                               atol=KERNEL_TOL["float32"], rtol=0)
    # non-causal: the first frame's output depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    other = TM._run_encoder(tparams, tc, torch.from_numpy(moved))
    assert float((other[:, 0] - got[:, 0]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------


def test_block_specs_and_cache_layout_match_reference():
    """Periods, specs and the cache tree (kv, xkv) for both families,
    including `cross_len`."""
    for arch in ARCHS:
        jc, tc = cfg_pair(arch, smoke=True)
        assert TM.period_of(tc) == JM.period_of(jc), arch
        assert TM.block_specs(tc) == JM.block_specs(jc), arch
        for cross_len in (None, 5):
            want = JM.init_caches(jc, 2, 12, cross_len=cross_len)
            got = TM.init_caches(tc, 2, 12, cross_len=cross_len,
                                 device="cpu")
            assert jax.tree.map(np.shape, want["layers"]) == jax.tree.map(
                np.shape, jax.tree.map(to_np, got["layers"])), arch
    assert [s["kind"] for s in TM.block_specs(tc)] == ["attn"]
    vlm = TM.block_specs(cfg_pair(VLM)[1])
    assert [s["kind"] for s in vlm] == ["attn"] * 4 + ["xattn"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jc, tc, jparams, tparams = _setup(arch)
    toks = _tokens(1, 2, 16, jc.vocab_size)
    extra = _extra(jc, 5, 2)
    want, _, _ = JM.forward(jparams, jc, toks, extra=_jx(extra), remat=False)
    for use_kernels in (True, False):
        got, aux, _ = TM.forward(tparams, tc, torch.from_numpy(toks),
                                 extra=_tx(extra), use_kernels=use_kernels)
        assert got.shape == (2, 16, tc.padded_vocab()) and float(aux) == 0
        np.testing.assert_allclose(to_np(got), to_np(want),
                                   atol=LOGIT_TOL_F32, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_path_is_live(arch):
    """The logits move by at least LIVE_FACTOR times the parity tolerance
    when the extras are zeroed or (VLM) the gate is 0: a dead or wrong
    cross path fails the parity tests above. (Readings: 0.0727 VLM, gate
    and extras alike; 0.0063 whisper, whose frames pass through the
    encoder's final norm.)"""
    jc, tc, _, tparams = _setup(arch)
    toks = torch.from_numpy(_tokens(1, 2, 16, jc.vocab_size))
    extra = _tx(_extra(jc, 5, 2))
    base, _, _ = TM.forward(tparams, tc, toks, extra=extra)
    zero, _, _ = TM.forward(tparams, tc, toks, extra={
        k: torch.zeros_like(v) for k, v in extra.items()})
    assert float((base - zero).abs().max()) > LIVE_FACTOR * LOGIT_TOL_F32
    if arch == VLM:
        shut = _setup(arch, gate=0.0)[3]
        off, _, _ = TM.forward(shut, tc, toks, extra=extra)
        assert float((base - off).abs().max()) > LIVE_FACTOR * LOGIT_TOL_F32
        # gate 0: the image embeddings do not matter
        off_zero, _, _ = TM.forward(shut, tc, toks, extra={
            k: torch.zeros_like(v) for k, v in extra.items()})
        np.testing.assert_array_equal(to_np(off), to_np(off_zero))


def _prefill_decode(jc, tc, jparams, tparams, extra, toks, P, cache_dtype):
    """Prefill toks[:, :P], then decode the rest; logits of both packages
    at every step (the reference under both its decode branches) and the
    final caches."""
    B, S = toks.shape
    jcache = JM.init_caches(jc, B, S, tp=1,
                            dtype=getattr(jnp, cache_dtype))
    tcache = TM.init_caches(tc, B, S, tp=1,
                            dtype=getattr(torch, cache_dtype), device="cpu")
    jl, _, jcache = JM.forward(jparams, jc, toks[:, :P], extra=_jx(extra),
                               caches=jcache, remat=False)
    tl, _, tcache = TM.forward(tparams, tc, torch.from_numpy(toks[:, :P]),
                               extra=_tx(extra), caches=tcache)
    steps = [(to_np(tl), to_np(jl))]
    jcaches = {False: jcache, True: jcache}
    for t in range(P, S):
        tl, tcache = TM.decode_step(tparams, tc,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    tcache)
        for carry in jcaches:
            jl, jcaches[carry] = JM.decode_step(
                jparams, jc, toks[:, t:t + 1], jcaches[carry],
                cache_in_carry=carry)
            steps.append((to_np(tl), to_np(jl)))
    return steps, tcache, jcaches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill into float32 caches, then decode 3 tokens: logits at 1e-4
    at every step under both of the reference's decode branches, and every
    cache leaf (kv, xkv) after the last step."""
    jc, tc, jparams, tparams = _setup(arch)
    toks = _tokens(2, 2, 12, jc.vocab_size)
    steps, tcache, jcaches = _prefill_decode(
        jc, tc, jparams, tparams, _extra(jc, 6, 2), toks, 9, "float32")
    for got, want in steps:
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL_F32, rtol=0)
    for jc_ in jcaches.values():
        want = caches_from_numpy(jax.tree.map(np.asarray, jc_))
        assert want["index"] == tcache["index"] == 12
        paths = jax.tree_util.tree_flatten_with_path(want["layers"])[0]
        assert any("xkv" in jax.tree_util.keystr(p) for p, _ in paths)
        for (path, w), g in zip(paths, jax.tree.leaves(
                jax.tree.map(to_np, tcache["layers"]))):
            np.testing.assert_allclose(g, to_np(w), atol=1e-5, rtol=0,
                                       err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_cache_keeps_the_projection_dtype(arch):
    """float32 weights under the default bf16 cache: the reference's
    prefill replaces `xkv` with the float32 projections, and decode reads
    them unrounded; the port's `xkv` becomes float32 too, equal to the
    reference's, while the self-attention kv stays bf16. Logits at 1e-4
    at every step."""
    jc, tc, jparams, tparams = _setup(arch)
    toks = _tokens(3, 2, 12, jc.vocab_size)
    steps, tcache, jcaches = _prefill_decode(
        jc, tc, jparams, tparams, _extra(jc, 7, 2), toks, 9, "bfloat16")
    for got, want in steps:
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL_F32, rtol=0)
    for i, c in enumerate(tcache["layers"]):
        if "kv" in c:
            assert c["kv"]["k"].dtype == torch.bfloat16
        if "xkv" in c:
            want = jcaches[False]["layers"][i]["xkv"]
            for n in ("k", "v"):
                assert c["xkv"][n].dtype == torch.float32
                assert want[n].dtype == jnp.float32
                np.testing.assert_allclose(to_np(c["xkv"][n]),
                                           to_np(want[n]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher forcing on the port alone, bf16 weights and caches (as
    tests/test_models.py:60): prefill + decode logits within the
    reference's 0.15 of the full forward's."""
    _, tc = cfg_pair(arch, smoke=True, f32=False)
    params = TM.init_params(torch.Generator().manual_seed(0), tc)
    for i, spec in enumerate(TM.block_specs(tc)):
        if spec["kind"] == "xattn":
            params["layers"][i]["attn"]["gate"].fill_(GATE)
    extra = {k: v.to(torch.bfloat16) for k, v in _tx(_extra(tc, 8, 2)).items()}
    toks = torch.from_numpy(_tokens(4, 2, 12, tc.vocab_size))
    full, _, _ = TM.forward(params, tc, toks, extra=extra)
    caches = TM.init_caches(tc, 2, 12, device="cpu")
    _, _, caches = TM.forward(params, tc, toks[:, :8], extra=extra,
                              caches=caches)
    errs = []
    for t in range(8, 12):
        lg, caches = TM.decode_step(params, tc, toks[:, t:t + 1], caches)
        errs.append(float((lg[:, 0].float() - full[:, t].float()).abs()
                          .max()))
    assert max(errs) < LOGIT_TOL_BF16, errs


def _leaf_errs(got, want):
    """Each leaf's largest |got - want| over its largest |want|."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = jax.tree.leaves(jax.tree.map(to_np, got))
    assert len(gl) == len(paths)
    return {jax.tree_util.keystr(p): float(np.abs(g - to_np(w)).max()
                                           / max(np.abs(to_np(w)).max(),
                                                 1e-30))
            for (p, w), g in zip(paths, gl)}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    """The loss and every gradient leaf (the encoder's and the gate's
    among them) of the port's `make_grad_fn` against jax.value_and_grad of
    the reference's train loss, with remat, on random extras."""
    jc, tc, jparams, tparams = _setup(arch)
    toks = _tokens(9, 4, 17, jc.vocab_size)
    extra = _extra(jc, 10, 4)

    def jloss(params):
        logits, aux, _ = JM.forward(params, jc, toks[:, :-1],
                                    extra=_jx(extra), remat=True)
        return jax_cross_entropy(logits, toks[:, 1:], jc.vocab_size) + aux
    jl, jg = jax.value_and_grad(jloss)(jparams)
    metrics, tg = make_grad_fn(tc)(tparams, {
        "tokens": torch.from_numpy(toks[:, :-1]),
        "labels": torch.from_numpy(toks[:, 1:]), "extra": _tx(extra)})
    assert float(metrics["loss"]) == pytest.approx(float(jl), rel=LOSS_RTOL)
    errs = _leaf_errs(tg, jg)
    assert max(errs.values()) <= GRAD_RTOL, errs
    names = set(errs)
    assert any("['encoder']" in n for n in names) == (arch == WHISPER)
    assert any("['gate']" in n for n in names) == (arch == VLM)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, microbatches):
    """One AdamW step from the same TrainState, the batch carrying random
    extras (split into microbatches with the tokens): the loss to 1e-5
    relative and the params after the step to 2e-5 (as
    tests/test_torch_train.py)."""
    jc, tc, jparams, _ = _setup(arch)
    oc = dict(lr=1e-3, warmup=2, total_steps=10)
    jstate = jax_adamw_init(jparams, JOptimizerConfig(**oc))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    jstep = jax.jit(jax_make_train_step(jc, JOptimizerConfig(**oc),
                                        microbatches=microbatches))
    tstep = make_train_step(tc, OptimizerConfig(**oc),
                            microbatches=microbatches)
    toks = _tokens(11, 4, 17, jc.vocab_size)
    extra = _extra(jc, 12, 4)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jstate, jm = jstep(jstate, {**batch, "extra": _jx(extra)})
    tstate, tm = tstep(tstate, {**{k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                                "extra": _tx(extra)})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_RTOL)
    assert tstate.step == 1
    for g, w in zip(jax.tree.leaves(jax.tree.map(to_np, tstate.params)),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(g, to_np(w), atol=2e-5, rtol=0)


def test_missing_extra_is_named():
    """A cross-attention family without its source raises and names it
    (`train_loop` feeds no extras, as the reference's does not)."""
    for arch, key in ((VLM, "image_embeds"), (WHISPER, "audio_frames")):
        _, tc, _, tparams = _setup(arch)
        with pytest.raises(ValueError, match=key):
            TM.forward(tparams, tc, torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------------------
# Conversion and serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_encoder_gate_and_cross_caches(arch):
    """bf16 params (the encoder subtree and the gate among them) convert
    leaf by leaf, exactly; and decode goes on from the reference's
    prefilled float32 caches (kv and xkv) converted by
    caches_from_numpy."""
    jc, tc, jparams, tparams = _setup(arch, f32=False)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = jax.tree_util.tree_flatten_with_path(tparams)[0]
    assert [jax.tree_util.keystr(p) for p, _ in want] == [
        jax.tree_util.keystr(p) for p, _ in got]
    assert any(("['encoder']" if arch == WHISPER else "['gate']")
               in jax.tree_util.keystr(p) for p, _ in want)
    for (path, w), (_, g) in zip(want, got):
        assert str(w.dtype) == str(g.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(to_np(g), to_np(w),
                                      err_msg=jax.tree_util.keystr(path))

    jc, tc, jparams, tparams = _setup(arch)
    toks = _tokens(13, 2, 10, jc.vocab_size)
    jcache = JM.init_caches(jc, 2, 10, tp=1, dtype=jnp.float32)
    _, _, jcache = JM.forward(jparams, jc, toks[:, :9],
                              extra=_jx(_extra(jc, 14, 2)), caches=jcache,
                              remat=False)
    tcache = caches_from_numpy(jax.tree.map(np.asarray, jcache))
    jl, _ = JM.decode_step(jparams, jc, toks[:, 9:], jcache)
    tl, _ = TM.decode_step(tparams, tc, torch.from_numpy(toks[:, 9:]),
                           tcache)
    np.testing.assert_allclose(to_np(tl), to_np(jl), atol=LOGIT_TOL_F32,
                               rtol=0)


def _jax_greedy(jc, jparams, prompts, extra, gen):
    """The reference serve's loop (make_prefill, make_serve_step) fed
    `extra` in place of its zero inputs."""
    B, P = prompts.shape
    caches = JM.init_caches(jc, B, P + gen, tp=1)
    logits, caches = jax_make_prefill(jc)(
        jparams, caches, {"tokens": prompts, "extra": _jx(extra)})
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    step = jax_make_serve_step(jc)
    out = [tok]
    for _ in range(gen - 1):
        tok, caches = step(jparams, caches, tok)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_match_reference(arch, use_kernels):
    """The serve entry point with random extras, float32 smoke, prompt 12,
    6 tokens: the reference's greedy tokens; on CPU tensors no kernel
    launch is counted."""
    from repro_torch.launch.serve import serve
    jc, tc, jparams, tparams = _setup(arch)
    B, P, G = 2, 12, 6
    prompts = _tokens(15, B, P, jc.vocab_size)
    extra = _extra(jc, 16, B)
    want = _jax_greedy(jc, jparams, prompts, extra, G)
    before = (fops.flash_attention.launches, dops.decode_attention.launches)
    got, _, logits = serve(tc, batch=B, prompt_len=P, gen=G, device="cpu",
                           params=tparams, prompts=torch.from_numpy(prompts),
                           extra=_tx(extra), use_kernels=use_kernels)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.isfinite(logits).all()
    assert (fops.flash_attention.launches,
            dops.decode_attention.launches) == before


@pytest.mark.parametrize("arch,layers,n_periods", [
    (VLM, "5", 1), (VLM, "10", 2), (WHISPER, "1", 1), (WHISPER, None, 2)])
def test_serve_cli_on_cpu(arch, layers, n_periods, monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --arch ... --smoke --device
    cpu` for both families, fed the reference's zero extras; `--layers`
    cuts whole VLM periods, and only whisper's decoder (its encoder keeps
    its 2 smoke layers)."""
    import sys
    from repro_torch.launch import serve as tserve
    seen = []
    real = TM.init_params

    def spy(gen, cfg, tp=1):
        params = real(gen, cfg, tp)
        enc = params.get("encoder")
        seen.append((params["layers"][0]["ln1"].shape[0],
                     enc and enc["layers"]["ln1"].shape[0]))
        return params
    monkeypatch.setattr(TM, "init_params", spy)
    argv = ["serve", "--arch", arch, "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--gen", "3"]
    monkeypatch.setattr(sys, "argv", argv + (["--layers", layers]
                                             if layers else []))
    tserve.main()
    assert "generated shape: (2, 3)" in capsys.readouterr().out
    (periods, enc_layers), = seen
    assert periods == n_periods
    assert enc_layers == (2 if arch == WHISPER else None)
