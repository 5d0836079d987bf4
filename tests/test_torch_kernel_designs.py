"""The order of operations of the decode-attention and WKV6 CUDA kernels,
emulated on the CPU.

The kernels (src/repro_torch/kernels/decode_attention/csrc/
decode_attention.cu and src/repro_torch/kernels/rwkv6/csrc/wkv6.cu) run
only on the card. This file repeats in plain torch, in float32, the way
each one cuts and orders its work, and holds that against the JAX
package's plain functions on inputs made from a numpy seed:

- decode: W cut into the splits that `split_plan` gives for a 132-SM card,
  each split walked in tiles with an online softmax (a warp's own over its
  16 slots of a tile, P split into two bf16 parts, in the tensor-core
  kernel that bf16 takes; the block's, with P V by slot groups, in the
  CUDA-core kernel that a float32 q takes), and the splits merged in split
  order, as the cluster merges them;
- wkv6: chunks of 16 tokens (32 at d = 16; a ragged last chunk
  zero-filled), exp(logw) and the bonus r . (u * k) computed per chunk, the
  rows of each state column split over eight lanes (four at d = 16), and
  o summed over the lanes' partials in lane order.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (WKV6_SWEEP, WKV6_TOL, both, decode_inputs,  # noqa: E402
                           to_np, wkv6_inputs)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_attention_ref)
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402

H100_SMS = 132
# float32 throughout, sums in another order than the reference's: the
# reference's float32 kernel tolerance (tests/test_kernels.py:33)
DECODE_TOL = 2e-5
THREADS = 256                  # the CUDA-core decode kernel's block
TC_WARPS = 4                   # the tensor-core decode kernel's warps


def _tile_slots(d: int, itemsize: int) -> int:
    """Slots of the CUDA-core decode kernel's tile (`Tile<TKV, D>::TS`)."""
    row = d * itemsize + 16
    return 128 if row <= 192 else 64 if row <= 384 else 32


def _bf16(x):
    return x.to(torch.bfloat16).float()


def decode_kernel_arithmetic(q, k, v, bias, pair, n_sm=H100_SMS):
    """q (B,1,H,d), k/v (B,W,K,d), bias (B,W), float32 holding values of
    the (q, cache) dtype `pair` -> the output before its rounding to q's
    dtype, and each split's m, in the decode kernel's order.

    bf16/bf16 takes the tensor-core kernel: 4 warps of 16 slots a 64-slot
    tile, each with its own online softmax, P split into two bf16 parts
    for P V, the warps merged in order. A float32 q takes the CUDA-core
    kernel: tiles as wide as the cache's rows allow, one online softmax a
    block, P V summed by slot groups and l by (head, slot) pairs."""
    B, _, H, d = q.shape
    W, K = k.shape[1], k.shape[2]
    G = H // K
    per, nsplit = dops.split_plan(W, B, K, n_sm)
    tensor_cores = pair == ("bfloat16", "bfloat16")
    if tensor_cores:
        ts, lanes, groups = 16 * TC_WARPS, 16, 1   # a "lane": a warp's slots
    else:
        ts = _tile_slots(d, 2 if pair[1] == "bfloat16" else 4)
        lanes, groups = ts, THREADS // (d // 2)
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, K, G, d)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)   # (B,K,W,d)
    parts = []
    for s in range(nsplit):
        lo = s * per * dops.SLOTS_PER_CHUNK
        hi = min(W, lo + per * dops.SLOTS_PER_CHUNK)
        n_warps = ts // lanes if tensor_cores else 1
        m = torch.full((n_warps, B, K, G), -1e30)
        l_part = torch.zeros((n_warps, B, K, G, lanes if not tensor_cores
                              else 1))
        acc = torch.zeros((n_warps, groups, B, K, G, d))
        for w0 in range(lo, hi, ts):
            for w in range(n_warps):
                a0 = w0 + w * lanes if tensor_cores else w0
                rows = max(0, min(lanes if tensor_cores else ts, hi - a0))
                sl = slice(a0, a0 + rows)
                if tensor_cores:
                    sc = torch.einsum("bkgd,bkjd->bkgj", qg, kt[:, :, sl])
                    sc = sc * scale + bias[:, None, None, sl]
                else:
                    sc = torch.einsum("bkgd,bkjd->bkgj", qg * scale,
                                      kt[:, :, sl]) + bias[:, None, None, sl]
                tile_max = (sc.amax(-1) if rows else
                            torch.full_like(m[w], -1e30))
                m_new = torch.maximum(m[w], tile_max)
                alpha = torch.exp(m[w] - m_new)
                p = torch.exp(sc - m_new[..., None])
                if tensor_cores:
                    l_part[w] = l_part[w] * alpha[..., None] + p.sum(
                        -1, keepdim=True)
                    p_hi = _bf16(p)
                    pv = (torch.einsum("bkgj,bkjd->bkgd", p_hi, vt[:, :, sl])
                          + torch.einsum("bkgj,bkjd->bkgd", _bf16(p - p_hi),
                                         vt[:, :, sl]))
                    acc[w, 0] = acc[w, 0] * alpha[..., None] + pv
                else:
                    l_part[w] = l_part[w] * alpha[..., None]
                    l_part[w, ..., :rows] += p
                    acc[w] = acc[w] * alpha[None, ..., None]
                    for sg in range(groups):
                        acc[w, sg] += torch.einsum(
                            "bkgj,bkjd->bkgd", p[..., sg::groups],
                            vt[:, :, a0 + sg:a0 + rows:groups])
                m[w] = m_new
        # the block's partial: the warps (tensor cores) or the slot groups
        # and pairs (CUDA cores), each in fixed order
        if tensor_cores:
            mb = m.amax(0)
            wsc = torch.exp(m - mb)
            l_blk = (l_part[0, ..., 0] * wsc[0])
            acc_blk = acc[0, 0] * wsc[0][..., None]
            for w in range(1, n_warps):
                l_blk = l_blk + l_part[w, ..., 0] * wsc[w]
                acc_blk = acc_blk + acc[w, 0] * wsc[w][..., None]
        else:
            mb = m[0]
            l_blk = l_part[0, ..., 0].clone()
            for j in range(1, lanes):
                l_blk = l_blk + l_part[0, ..., j]
            acc_blk = acc[0, 0].clone()
            for sg in range(1, groups):
                acc_blk = acc_blk + acc[0, sg]
        parts.append((mb, l_blk, acc_blk))
    mx = parts[0][0]
    for mb, _, _ in parts[1:]:
        mx = torch.maximum(mx, mb)
    l_tot = torch.zeros_like(mx)
    a_tot = torch.zeros((B, K, G, d))
    for mb, l_blk, acc_blk in parts:            # in split order
        w = torch.exp(mb - mx)
        l_tot = l_tot + l_blk * w
        a_tot = a_tot + acc_blk * w[..., None]
    out = a_tot / torch.clamp(l_tot, min=1e-30)[..., None]
    return out.reshape(B, 1, H, d), [p[0] for p in parts]


# B, W, H, K, d, the mask, the (q, cache) dtypes. "split s" masks every
# slot of split s; W not a multiple of the tile; G = 1, 2, 4, 16; all
# three dtype pairs; h2o-danube-1.8b's decode shape, where at the last
# decode step every slot of the 4096-slot ring holds a valid position
BF, F32 = ("bfloat16", "bfloat16"), ("float32", "float32")
MIXED = ("float32", "bfloat16")
DECODE_CASES = [(1, 1024, 16, 1, 64, "split 0", BF),
                (1, 1024, 16, 1, 64, "split 0", MIXED),
                (1, 4096, 4, 1, 112, "split 1", BF),
                (2, 300, 4, 4, 80, "random", BF),
                (2, 300, 4, 4, 80, "random", MIXED),
                (1, 777, 32, 2, 128, "split 0", F32),
                (2, 33, 16, 1, 32, "random", F32),
                (2, 33, 16, 1, 32, "random", BF),
                (2, 1000, 4, 1, 80, "random", F32),
                (4, 4096, 32, 8, 80, "ring", BF)]


def _decode_case(B, W, H, K, d, mask, pair):
    q, k, v, bias = decode_inputs(11, B, W, H, K, d)
    if pair[0] == "bfloat16":
        q = to_np(_bf16(torch.from_numpy(q)))
    if pair[1] == "bfloat16":
        k, v = (to_np(_bf16(torch.from_numpy(x))) for x in (k, v))
    if mask == "ring":
        bias = np.zeros((B, W), np.float32)
    elif mask != "random":
        per, _ = dops.split_plan(W, B, K, H100_SMS)
        s = int(mask.split()[1])
        span = per * dops.SLOTS_PER_CHUNK
        bias[:, s * span:(s + 1) * span] = -1e30
    return q, k, v, bias


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_split_and_merge_match_the_reference(case):
    """Held to 2e-5 before the output's rounding: the card gate's float32
    part (the tensor-core path's split p keeps ~2^-17 of p, as the flash
    kernel's, tests/test_torch_flash_split.py)."""
    q, k, v, bias = _decode_case(*case)
    want = to_np(jax_decode_attention_ref(*(both(x)[0]
                                            for x in (q, k, v, bias))))
    got, ms = decode_kernel_arithmetic(
        *(torch.from_numpy(x) for x in (q, k, v, bias)), case[-1])
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=DECODE_TOL)
    if case[5].startswith("split"):
        # the masked split's m is -1e30: its weight exp(m - M) in the merge
        # is exactly 0
        m = ms[int(case[5].split()[1])]
        assert torch.all(m == -1e30)
        assert torch.all(torch.exp(m - torch.stack(ms).amax(0)) == 0)


@pytest.mark.parametrize("W,B,K", [(4096, 4, 8), (300, 2, 4), (33, 2, 1),
                                   (1024, 1, 1), (65536, 1, 8),
                                   (129, 64, 8)])
def test_split_plan_fills_the_card_without_empty_splits(W, B, K):
    per, nsplit = dops.split_plan(W, B, K, H100_SMS)
    chunks = -(-W // dops.SLOTS_PER_CHUNK)
    assert 1 <= nsplit <= dops.MAX_SPLITS and per >= 1
    assert (nsplit - 1) * per < chunks <= nsplit * per  # none empty
    # as many splits as fill BLOCKS_PER_SM blocks an SM, as the cap and W
    # allow
    fill = -(-dops.BLOCKS_PER_SM * H100_SMS // (B * K))
    assert nsplit <= max(1, min(dops.MAX_SPLITS, chunks, fill))
    if (W, B, K) == (4096, 4, 8):           # h2o-danube-1.8b: 256 blocks
        assert (per, nsplit) == (4, 8)


def wkv6_kernel_arithmetic(r, k, v, logw, u):
    """r, k, v, logw (B,H,S,d), u (H,d), float32 -> (o, S_final) in the
    WKV6 kernel's order."""
    B, H, S, d = r.shape
    cols = 4 if d >= 32 else 2               # state columns a thread
    lanes = 8 if d >= 32 else 4              # lanes that split the rows
    T = 16 if d >= 32 else 32                # tokens a chunk
    tpt = d // cols * lanes // T             # threads a token's bonus
    per = d // tpt
    # rows of lane q: 4 (q + lanes m) + c, in the kernel's loop order
    rows = [[4 * (q + lanes * m) + c for m in range(d // (4 * lanes))
             for c in range(4)] for q in range(lanes)]
    state = torch.zeros((B, H, d, d))
    outs = []
    for c0 in range(0, S, T):
        n = min(T, S - c0)
        pad = (0, 0, 0, T - n)               # the zero-filled ragged tail
        rc, kc, vc, lc = (torch.nn.functional.pad(x[:, :, c0:c0 + n], pad)
                          for x in (r, k, v, logw))
        wc = torch.exp(lc)
        # bonus: tpt parts of `per` rows, then the xor-shuffle tree
        part = [(rc[..., p * per:(p + 1) * per]
                 * u[None, :, None, p * per:(p + 1) * per]
                 * kc[..., p * per:(p + 1) * per]).sum(-1)
                for p in range(tpt)]
        while len(part) > 1:
            part = [part[i] + part[i + 1] for i in range(0, len(part), 2)]
        bonus = part[0]
        for t in range(n):
            lane = []
            for q in range(lanes):
                a = torch.zeros((B, H, d))
                for i in rows[q]:
                    a = a + rc[:, :, t, i, None] * state[:, :, i]
                lane.append(a)
            # lane 0 adds the bonus term; the partials summed in lane order
            o = lane[0] + bonus[:, :, t, None] * vc[:, :, t]
            for a in lane[1:]:
                o = o + a
            outs.append(o)
            state = (wc[:, :, t, :, None] * state
                     + kc[:, :, t, :, None] * vc[:, :, t, None, :])
    return torch.stack(outs, dim=2), state


def _wkv6_case(case):
    B, H, S, d, logw = case
    r, k, v, lw, u = wkv6_inputs(13, B, H, S, d)
    if logw is not None:
        lw = np.full_like(lw, logw)
        u = np.zeros_like(u)
    return r, k, v, lw, u


# the reference's sweep (S = 100 and 65: ragged last chunks), S one below
# and one above a chunk, S = 1, and the two strong-decay cases (B,H,S,d,
# logw or None for the sweep's scaling)
WKV6_CASES = ([c + (None,) for c in WKV6_SWEEP]
              + [(1, 2, 31, 32, None), (2, 1, 33, 16, None),
                 (1, 1, 1, 64, None), (1, 1, 128, 32, -30.0),
                 (1, 1, 128, 32, -1e-6)])


@pytest.mark.parametrize("case", WKV6_CASES, ids=str)
def test_wkv6_chunked_lanes_match_the_reference(case):
    """Held to the reference's 1e-4 (tests/test_kernels.py:88); under
    near-perfect memory (logw = -1e-6) the outputs reach ~|40| after 128
    tokens, and float32 rounding of those adds 1e-5 relative."""
    r, k, v, lw, u = _wkv6_case(case)
    B, H, S, d, logw = case
    s0 = np.zeros((B, H, d, d), np.float32)
    want_o, want_s = (to_np(x) for x in jax_wkv6_ref(
        *(both(x)[0] for x in (r, k, v, lw, u, s0))))
    got_o, got_s = wkv6_kernel_arithmetic(
        *(torch.from_numpy(x) for x in (r, k, v, lw, u)))
    rtol = 0.0 if logw is None else 1e-5
    assert torch.isfinite(got_o).all() and torch.isfinite(got_s).all()
    np.testing.assert_allclose(to_np(got_o), want_o, atol=WKV6_TOL,
                               rtol=rtol)
    np.testing.assert_allclose(to_np(got_s), want_s, atol=WKV6_TOL,
                               rtol=rtol)
