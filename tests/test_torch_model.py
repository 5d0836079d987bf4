"""The port's dense model (`repro_torch.models.model`) against
`repro.models.model`, on the reference's parameters converted by
`repro_torch.convert`, plus the reference's own model properties
(tests/test_models.py:60-104) run on the port."""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (LOGIT_TOL_BF16, LOGIT_TOL_F32, cfg_pair,  # noqa: E402
                           jax_to_torch, to_np)
from repro.models import model as JM  # noqa: E402
from repro_torch.convert import caches_from_numpy  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

# (arch, smoke, overrides): lovelock-20m at its real width and 2 layers,
# the smoke variants of h2o-danube-1.8b (SWA) and qwen3-32b (qk_norm)
CONFIGS = [("lovelock-20m", False, {"num_layers": 2}),
           ("h2o-danube-1.8b", True, {}),
           ("qwen3-32b", True, {})]
IDS = [c[0] for c in CONFIGS]


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _setup(arch, smoke, over, tp=1, f32=True):
    return _setup_cached(arch, smoke, tuple(sorted(over.items())), tp, f32)


@functools.cache
def _setup_cached(arch, smoke, over, tp, f32):
    """Config pair and the reference's params (read-only in the tests)."""
    jc, tc = cfg_pair(arch, smoke=smoke, f32=f32, **dict(over))
    jparams = _jax_init(jax.random.PRNGKey(0), jc, tp)
    return jc, tc, jparams, jax_to_torch(jparams)


_jax_init = jax.jit(JM.init_params, static_argnums=(1, 2))


@pytest.mark.parametrize("arch,smoke,over", CONFIGS, ids=IDS)
def test_forward_matches_reference(arch, smoke, over):
    jc, tc, jparams, tparams = _setup(arch, smoke, over)
    toks = _tokens(1, 2, 16, jc.vocab_size)
    want, _, _ = JM.forward(jparams, jc, toks, remat=False)
    for use_kernels in (True, False):
        got, aux, _ = TM.forward(tparams, tc, torch.from_numpy(toks),
                                 use_kernels=use_kernels)
        assert got.shape == (2, 16, tc.padded_vocab()) and float(aux) == 0
        np.testing.assert_allclose(to_np(got), to_np(want),
                                   atol=LOGIT_TOL_F32, rtol=0)


@pytest.mark.parametrize("arch,smoke,over", CONFIGS, ids=IDS)
def test_prefill_and_decode_match_reference(arch, smoke, over):
    """Prefill into caches, then decode 3 tokens; logits and caches match
    the reference's, under both of its decode branches (cache_in_carry),
    step by step."""
    jc, tc, jparams, tparams = _setup(arch, smoke, over)
    toks = _tokens(2, 2, 12, jc.vocab_size)
    P = 9
    jcache = JM.init_caches(jc, 2, 12, tp=1, dtype=jax.numpy.float32)
    tcache = TM.init_caches(tc, 2, 12, tp=1, dtype=torch.float32,
                            device="cpu")
    assert jax.tree.map(np.shape, jcache["layers"]) == [
        {"kv": {n: tuple(t.shape) for n, t in c["kv"].items()}}
        for c in tcache["layers"]]
    jl, _, jcache = JM.forward(jparams, jc, toks[:, :P], caches=jcache,
                               remat=False)
    tl, _, tcache = TM.forward(tparams, tc, torch.from_numpy(toks[:, :P]),
                               caches=tcache)
    np.testing.assert_allclose(to_np(tl), to_np(jl), atol=LOGIT_TOL_F32,
                               rtol=0)
    assert tcache["index"] == int(jcache["index"]) == P
    jcaches = {False: jcache, True: jcache}
    for t in range(P, 12):
        tl, tcache = TM.decode_step(tparams, tc,
                                    torch.from_numpy(toks[:, t:t + 1]),
                                    tcache)
        for carry in jcaches:
            jl, jcaches[carry] = JM.decode_step(
                jparams, jc, toks[:, t:t + 1], jcaches[carry],
                cache_in_carry=carry)
            np.testing.assert_allclose(to_np(tl), to_np(jl),
                                       atol=LOGIT_TOL_F32, rtol=0)
    for carry, jc_ in jcaches.items():
        want = caches_from_numpy(jax.tree.map(np.asarray, jc_))
        assert want["index"] == tcache["index"] == 12
        for n in ("k", "v"):
            np.testing.assert_allclose(to_np(tcache["layers"][0]["kv"][n]),
                                       to_np(want["layers"][0]["kv"][n]),
                                       atol=1e-5, rtol=0)


def test_decode_from_converted_reference_caches():
    """caches_from_numpy: decode continues from the reference's prefill."""
    jc, tc, jparams, tparams = _setup("h2o-danube-1.8b", True, {})
    toks = _tokens(3, 2, 10, jc.vocab_size)
    jcache = JM.init_caches(jc, 2, 10, tp=1, dtype=jax.numpy.float32)
    _, _, jcache = JM.forward(jparams, jc, toks[:, :9], caches=jcache,
                              remat=False)
    tcache = caches_from_numpy(jax.tree.map(np.asarray, jcache))
    jl, _ = JM.decode_step(jparams, jc, toks[:, 9:], jcache)
    tl, _ = TM.decode_step(tparams, tc, torch.from_numpy(toks[:, 9:]),
                           tcache)
    np.testing.assert_allclose(to_np(tl), to_np(jl), atol=LOGIT_TOL_F32,
                               rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-32b", "h2o-danube-1.8b"])
def test_decode_matches_forward(arch):
    """Teacher forcing on the port alone, bf16: prefill + decode logits
    equal the full forward's (as tests/test_models.py:60)."""
    _, tc = cfg_pair(arch, smoke=True, f32=False)
    params = TM.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.from_numpy(_tokens(4, 2, 12, tc.vocab_size))
    full, _, _ = TM.forward(params, tc, toks)
    caches = TM.init_caches(tc, 2, 12, device="cpu")
    _, _, caches = TM.forward(params, tc, toks[:, :8], caches=caches)
    errs = []
    for t in range(8, 12):
        lg, caches = TM.decode_step(params, tc, toks[:, t:t + 1], caches)
        errs.append(float((lg[:, 0].float() - full[:, t].float()).abs()
                          .max()))
    assert max(errs) < LOGIT_TOL_BF16, errs


def test_swa_ring_cache_decode():
    """SWA decode with a ring cache smaller than the sequence (as
    tests/test_models.py:83)."""
    _, tc = cfg_pair("h2o-danube-1.8b", smoke=True, f32=False,
                     sliding_window=8)
    params = TM.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.from_numpy(_tokens(5, 1, 24, tc.vocab_size))
    full, _, _ = TM.forward(params, tc, toks)
    caches = TM.init_caches(tc, 1, 24, device="cpu")
    assert caches["layers"][0]["kv"]["k"].shape[2] == 8
    _, _, caches = TM.forward(params, tc, toks[:, :20], caches=caches)
    errs = []
    for t in range(20, 24):
        lg, caches = TM.decode_step(params, tc, toks[:, t:t + 1], caches)
        errs.append(float((lg[:, 0].float() - full[:, t].float()).abs()
                          .max()))
    assert max(errs) < LOGIT_TOL_BF16, errs


@pytest.mark.parametrize("arch,smoke,over,tp", [
    ("qwen3-32b", True, {}, 4),                 # K < tp: kv repeated
    ("lovelock-20m", False, {"num_layers": 2, "num_kv_heads": 3}, 2),
])                                              # K >= tp: kv groups padded
def test_head_padding_is_exact(arch, smoke, over, tp):
    """TP-padded layouts compute the same function, in the port and
    against the reference's padded parameters."""
    jc, tc, jparams, tparams = _setup(arch, smoke, over, tp=tp)
    toks = _tokens(6, 2, 16, jc.vocab_size)
    want, _, _ = JM.forward(jparams, jc, toks, remat=False)
    got, _, _ = TM.forward(tparams, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(to_np(got), to_np(want), atol=LOGIT_TOL_F32,
                               rtol=0)
    outs = []
    for t in (1, tp):
        params = TM.init_params(torch.Generator().manual_seed(0), tc, tp=t)
        lg, _, _ = TM.forward(params, tc, torch.from_numpy(toks))
        outs.append(to_np(lg))
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch,smoke,over,tp,f32", [
    ("qwen3-32b", True, {}, 4, False),          # bf16, qk_norm, kv repeated
    ("lovelock-20m", False, {"num_layers": 2, "num_kv_heads": 3}, 2, True),
    ("whisper-large-v3", True, {}, 1, False),   # the encoder, ln_x / xattn
    ("llama-3.2-vision-90b", True, {}, 4, False),   # the float32 gate
])
def test_init_params_matches_reference_layout(arch, smoke, over, tp, f32):
    """Same tree, shapes, dtypes and scales as the reference (not values)."""
    jc, tc, jparams, _ = _setup(arch, smoke, over, tp=tp, f32=f32)
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = TM.init_params(torch.Generator().manual_seed(0), tc, tp=tp)
    for path, leaf in want:
        t = got
        for key in path:
            t = t[getattr(key, "key", getattr(key, "idx", None))]
        a, b = np.asarray(leaf).astype(np.float32), to_np(t)
        assert a.shape == b.shape, path
        assert str(leaf.dtype) == str(t.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(a == 0, b == 0)   # same zero padding
        if a.std() > 0:
            assert abs(b.std() / a.std() - 1) < 0.05, path
