"""The port's Mamba layer (`_mamba_ssm_chunked`, `mamba`) against
`repro.models.layers`, on the same numpy inputs, float32; and the scan's
kernel wrapper (`ops.mamba_scan`) on CPU tensors against the plain form.
The kernel itself is held to the plain form on the card by
tests/test_torch_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cfg_pair, to_np  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as mops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

SSM_TOL = 1e-5    # float32; the in-chunk scans round in different orders


def _ssm_inputs(seed, B, S, I, N):
    """dt in (0, 0.5), A = -(1..N), B, C, x normal, a nonzero h0."""
    rng = np.random.default_rng(seed)
    dt = (rng.random((B, S, I)) * 0.5).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (I, N))
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    x = rng.standard_normal((B, S, I)).astype(np.float32)
    h0 = rng.standard_normal((B, I, N)).astype(np.float32)
    return dt, np.ascontiguousarray(A), Bm, Cm, x, h0


@pytest.mark.parametrize("S", [512, 300, 1, 7])
def test_ssm_chunked_matches_reference(S):
    """Two chunks of 256 (S=512), one chunk of 300, one token, and a
    ragged chunk of 7 (its doubling steps cross no power of two), from a
    nonzero h0: y and the final state to 1e-5."""
    args = _ssm_inputs(S, 2, S, 8, 4)
    jy, jh = JL._mamba_ssm_chunked(*map(jnp.asarray, args))
    ty, th = TL._mamba_ssm_chunked(*map(torch.from_numpy, args))
    assert ty.shape == (2, S, 8) and th.shape == (2, 8, 4)
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), atol=SSM_TOL,
                               rtol=0)
    np.testing.assert_allclose(to_np(th), np.asarray(jh), atol=SSM_TOL,
                               rtol=0)


def test_ssm_chunked_matches_per_token_recurrence():
    """The doubling scan against the recurrence written token by token."""
    dt, A, Bm, Cm, x, h0 = map(torch.from_numpy, _ssm_inputs(3, 1, 40, 4, 3))
    h, ys = h0.clone(), []
    for t in range(40):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    y, hT = TL._mamba_ssm_chunked(dt, A, Bm, Cm, x, h0)
    torch.testing.assert_close(y, torch.stack(ys, 1), atol=SSM_TOL, rtol=0)
    torch.testing.assert_close(hT, h, atol=SSM_TOL, rtol=0)


def test_ssm_chunked_needs_whole_chunks():
    """S = 600 is two chunks of 300; S = 601 is not a whole number of
    chunks, which the reference's reshape refuses too."""
    args = _ssm_inputs(5, 1, 600, 4, 2)
    y, _ = TL._mamba_ssm_chunked(*map(torch.from_numpy, args))
    assert y.shape == (1, 600, 4)
    args = _ssm_inputs(5, 1, 601, 4, 2)
    with pytest.raises(ValueError, match="multiple"):
        TL._mamba_ssm_chunked(*map(torch.from_numpy, args))


def test_mamba_scan_on_cpu_reads_bf16_as_its_float32_copies():
    """bf16 dt, Bm, Cm and xin: ops.mamba_scan computes on their float32
    values, exactly as the plain form on `.float()` copies, and hands the
    gradients back in bf16."""
    args = [torch.from_numpy(a) for a in _ssm_inputs(9, 2, 40, 8, 4)]
    for i in (0, 2, 3, 4):
        args[i] = args[i].bfloat16()
    t = [a.clone().requires_grad_() for a in args]
    y, h = mops.mamba_scan(*t)
    wy, wh = TL._mamba_ssm_chunked(*(a.float() for a in args))
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, wy, atol=0, rtol=0)
    torch.testing.assert_close(h, wh, atol=0, rtol=0)
    grads = torch.autograd.grad(y.sum() + h.sum(), t)
    assert [g.dtype for g in grads] == [a.dtype for a in args]


@pytest.mark.parametrize("S", [512, 300, 1, 7])
def test_mamba_scan_on_cpu_is_the_plain_form(S):
    """ops.mamba_scan on CPU tensors runs the plain form, launches
    nothing, and its gradient (autograd of the plain form recomputed from
    the saved inputs, h0 included) is plain autograd's: y, h_final and
    every input's gradient, exactly."""
    args = [torch.from_numpy(a) for a in _ssm_inputs(S + 11, 2, S, 8, 4)]
    g_y, g_h = (torch.from_numpy(np.random.default_rng(S).standard_normal(
        shape).astype(np.float32)) for shape in ((2, S, 8), (2, 8, 4)))
    n = mops.mamba_scan.launches
    got_in = [a.clone().requires_grad_() for a in args]
    y, h = mops.mamba_scan(*got_in)
    got = torch.autograd.grad((y, h), got_in, (g_y, g_h))
    want_in = [a.clone().requires_grad_() for a in args]
    wy, wh = TL._mamba_ssm_chunked(*want_in)
    want = torch.autograd.grad((wy, wh), want_in, (g_y, g_h))
    assert mops.mamba_scan.launches == n
    torch.testing.assert_close(y, wy, atol=0, rtol=0)
    torch.testing.assert_close(h, wh, atol=0, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_mamba_scan_needs_whole_chunks():
    """The wrapper keeps the plain form's contract on every path: S = 601
    is not a whole number of chunks."""
    args = _ssm_inputs(5, 1, 601, 4, 2)
    with pytest.raises(ValueError, match="multiple"):
        mops.mamba_scan(*map(torch.from_numpy, args))


def test_mamba_block_scans_through_the_wrapper(monkeypatch):
    """`mamba` hands its scan to ops.mamba_scan, once a call, with
    contiguous operands in the model's dtype (Bm and Cm are slices of one
    projection); on meta tensors (the dry-run) it traces the plain form
    instead."""
    _, tc, p, rng = _mamba_case(4)
    calls, real = [], mops.mamba_scan

    def counted(*args):
        calls.append([(a.dtype, a.is_contiguous()) for a in args])
        return real(*args)
    monkeypatch.setattr(mops, "mamba_scan", counted)
    x = torch.from_numpy(rng.standard_normal((2, 5, tc.d_model)).astype(
        np.float32))
    TL.mamba(jax.tree.map(torch.from_numpy, p), x, tc)
    assert calls == [[(torch.float32, True)] * 6]
    meta = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), p)
    out, st = TL.mamba(meta, x.to("meta"), tc)
    assert len(calls) == 1 and out.shape == x.shape
    assert st["ssm"].shape == (2, 2 * tc.d_model, tc.mamba.d_state)


def _mamba_case(seed):
    """jamba's smoke widths in float32 (D 64, I 128, N 16, dc 4, R 4) and
    parameters scaled as the reference's init, with a nonzero conv bias
    and dt_bias spread so that softplus sees both signs."""
    jc, tc = cfg_pair("jamba-v0.1-52b", smoke=True)
    D, m = jc.d_model, jc.mamba
    I, N, R = m.expand * D, m.d_state, D // 16
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    p = {"in_proj": w(D, 2 * I), "conv_w": w(m.d_conv, I, s=0.3),
         "conv_b": w(I, s=0.1), "x_proj": w(I, R + 2 * N),
         "dt_proj": w(R, I), "dt_bias": w(I, s=1.0) - 1.0,
         "A_log": np.log(np.broadcast_to(
             np.arange(1, N + 1, dtype=np.float32), (I, N))).copy(),
         "Dskip": np.ones(I, np.float32), "out_proj": w(I, D)}
    return jc, tc, p, rng


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_matches_reference(with_state):
    """The block over 20 tokens, from zero or from a given conv and SSM
    state: output and new state to 1e-5."""
    jc, tc, p, rng = _mamba_case(1)
    D, I, N, dc = jc.d_model, 2 * jc.d_model, 16, 4
    x = rng.standard_normal((2, 20, D)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.standard_normal((2, dc - 1, I)).astype(
                     np.float32),
                 "ssm": rng.standard_normal((2, I, N)).astype(np.float32)}
    jo, jst = JL.mamba(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc,
                       state=None if state is None else
                       jax.tree.map(jnp.asarray, state))
    to, tst = TL.mamba(jax.tree.map(torch.from_numpy, p),
                       torch.from_numpy(x), tc,
                       state=None if state is None else
                       jax.tree.map(torch.from_numpy, state))
    np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=SSM_TOL,
                               rtol=0)
    for n in ("conv", "ssm"):
        np.testing.assert_allclose(to_np(tst[n]), np.asarray(jst[n]),
                                   atol=SSM_TOL, rtol=0)


def test_mamba_decode_by_steps_equals_forward():
    """Prefill 9 tokens, then 7 one-token steps carrying the state: the
    outputs equal the 16-token forward's, and so does the final state."""
    _, tc, p, rng = _mamba_case(2)
    tp = jax.tree.map(torch.from_numpy, p)
    x = torch.from_numpy(rng.standard_normal((2, 16, tc.d_model)).astype(
        np.float32))
    full, full_st = TL.mamba(tp, x, tc)
    out, st = TL.mamba(tp, x[:, :9], tc)
    outs = [out]
    for t in range(9, 16):
        o, st = TL.mamba(tp, x[:, t:t + 1], tc, state=st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=SSM_TOL,
                               rtol=0)
    for n in ("conv", "ssm"):
        torch.testing.assert_close(st[n], full_st[n], atol=SSM_TOL, rtol=0)


def test_mamba_other_conv_widths():
    """d_conv 1 (no conv state) and 2, against the reference."""
    for dc in (1, 2):
        jc, tc, p, rng = _mamba_case(3)
        jc = dataclasses.replace(jc, mamba=dataclasses.replace(jc.mamba,
                                                               d_conv=dc))
        tc = dataclasses.replace(tc, mamba=dataclasses.replace(tc.mamba,
                                                               d_conv=dc))
        p = dict(p, conv_w=p["conv_w"][:dc])
        x = rng.standard_normal((1, 6, jc.d_model)).astype(np.float32)
        jo, jst = JL.mamba(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc)
        to, tst = TL.mamba(jax.tree.map(torch.from_numpy, p),
                           torch.from_numpy(x), tc)
        np.testing.assert_allclose(to_np(to), np.asarray(jo), atol=SSM_TOL,
                                   rtol=0)
        assert tst["conv"].shape == jst["conv"].shape == (1, dc - 1,
                                                          2 * jc.d_model)


def test_softplus_matches_reference():
    """torch's softplus is the identity above its threshold of 20, where
    jax.nn.softplus adds log1p(exp(-x)) < 2.1e-9: below half an ulp of
    x there, so the two agree exactly above 20. Elsewhere they agree to
    float32 rounding: within 2 ulp, as each library's exp and log1p round
    on their own (2 ulp at 5 of the 4,204 points when this was written)."""
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        np.linspace(19.9, 20.1, 201), [80.0, 1e4]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = to_np(torch.nn.functional.softplus(torch.from_numpy(x)))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 2 * ulp).all()
    above = x > 20
    assert (got[above] == x[above]).all()
