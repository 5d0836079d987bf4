#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA card and nvcc (the
kernels are built from the checkout's sources at first use). Phases, in
order; any failure ends the run with a non-zero exit and no result line:

1. card    -- require CUDA, print the card's name and power limit, turn
              TF32 off for float32 products and convolutions;
2. build   -- compile every kernel of the package (one nvcc per source,
              all at once) and print build seconds and ptxas usage;
3. kernels -- hold each kernel against its plain PyTorch version run in
              float32 on the same (bf16-rounded) inputs, on the
              reference's test sweeps (both dtypes) and at h2o-danube's
              shapes: |kernel - plain| <= 2e-5 + r |plain|, with r = 2^-8
              (the rounding of a bf16 output) for bf16 outputs and 0 for
              float32 ones; wkv6 (float32 only) on the reference's sweep,
              its two strong-decay cases and rwkv6-7b's training shape, to
              the reference's 1e-4, and its gradient (autograd of the
              chunked form) against autograd of the per-token plain
              version; bf16 flash also at every head dim (the
              tensor-core kernel; float32 takes the CUDA-core one); time
              kernel, plain version and one PyTorch library call (a
              yardstick only; none computes WKV6) with CUDA events, and
              the kernels' and library calls' device-only time with
              torch.profiler;
4. serve   -- serve h2o-danube-1.8b at full width and depth (random bf16
              weights from --seed): batch 4, prompt 4160 (> the 4096
              window), 32 generated tokens, through the kernels; check the
              launch counts. Then teacher-force the same tokens through
              the plain path in bf16 and, with the weights cast to
              float32, through both paths in float32. In float32 the
              kernel path must match the plain path to 1e-4 at every
              position. In bf16 each path is held against float32: at no
              position may the kernel path's largest logit error exceed
              the plain path's by more than BF16_EXCESS_TOL, and its RMS
              error over all logits may be at most BF16_RMS_RATIO times
              the plain path's. Last, trace a few decode steps with
              torch.profiler: device time and kernels per step, and the
              device's idle share against the steady decode step;
5. train   -- (a) lovelock-20m at full size in float32: 3 train steps
              from the same weights and batches through the kernel path
              and the plain path; losses within 1e-5 relative, the flash
              kernel launched once per layer per step and once more in the
              remat recompute. (b) rwkv6-7b at full width, 2 layers,
              float32, batch 4 x 512 tokens: the loss and every gradient
              leaf of one train step through both paths (the WKV6 forward
              is the kernel on one and the chunked form on the other; both
              backwards are the chunked form's autograd); loss within 1e-5
              relative, each leaf within GRAD_TOL of its largest |g|.
              (c) rwkv6-7b at full width, 8 of 32 layers, bf16, through
              `train_loop`: batch 4 x 2048 tokens, 3 steps; finite losses,
              wkv6 launched 2 x 8 times a step (forward and remat
              recompute); step times, tokens/s and peak device memory;
              then the same run through the plain path, its first loss
              within BF16_LOSS_RTOL; then the kernel path at lr 0 and at a
              tenth of the lr: no loss of the latter may exceed the
              initial weights' loss on the same batch by more than
              LOW_LR_RTOL;
6. result  -- print the kernels' JSON line, then the device line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 rate; dense bf16 tensor-core and fp32 CUDA-core
# peaks (at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the reference's kernel sweeps: tests/test_kernels.py:19-25 and :60-61
FLASH_SWEEP = [  # B, S, H, K, d, causal, window
    (2, 256, 4, 2, 64, True, None), (1, 384, 8, 8, 128, True, None),
    (2, 200, 4, 1, 80, True, 96), (1, 128, 2, 2, 32, False, None),
    (1, 130, 6, 2, 112, True, None)]
# bf16 takes the tensor-core kernel: each head dim at an S that is not a
# multiple of its 128-row q-tile and spans three of them, GQA, a window
FLASH_BF16_DIMS = [(2, 300, 8, 2, d, True, 100) for d in (32, 64, 80, 112,
                                                          128)]
DECODE_SWEEP = [(2, 512, 4, 2, 64), (1, 300, 8, 8, 128),  # B, W, H, K, d
                (2, 1000, 4, 1, 80)]
# the serve run: h2o-danube-1.8b, prompt longer than its 4096 window
ARCH, BATCH, PROMPT, GEN = "h2o-danube-1.8b", 4, 4160, 32
KERNEL_TOL = 2e-5          # float32, tests/test_kernels.py:33
BF16_OUT_REL = 2.0 ** -8   # bf16's unit roundoff: an output's rounding
LOGIT_TOL_F32 = 1e-4       # float32 logits, the port's CPU parity tests
# bf16 logits against the float32 run, kernel path vs plain path: limits
# set a little above the readings of full runs on the H100 (PERF.md)
BF16_EXCESS_TOL = 0.05   # read: 0.0231
BF16_RMS_RATIO = 1.02    # read: 0.9990
PROFILE_STEPS = 4          # decode steps traced by torch.profiler
# wkv6: the reference's sweep (tests/test_kernels.py:77-79) and rwkv6-7b's
# training shape; float32 in and out, held to the reference's 1e-4
# (tests/test_kernels.py:88)
WKV6_SWEEP = [(2, 2, 128, 32), (1, 4, 100, 64), (2, 1, 64, 16),
              (1, 2, 65, 64)]             # B, H, S, d
WKV6_TOL = 1e-4
# under near-perfect memory (logw = -1e-6) the outputs of N(0,1) inputs
# reach ~|40| after 128 tokens: float32 rounding of those, relative
WKV6_STABLE_RTOL = 1e-5
# the train phase
RWKV = "rwkv6-7b"
LOVELOCK = ("lovelock-20m", 8, 256, 3)        # arch, batch, seq, steps
RWKV_PARITY = (2, 4, 512)                     # layers, batch, seq
RWKV_TRAIN = (8, 4, 2048, 3)                  # layers, batch, seq, steps
# train_loop's lr is 3e-4 with a 10-step warmup: the loss of step i comes
# after i updates, of lr 3e-5, 6e-5, ... At that lr the 8-layer loss jumps
# above ln V on step 2 on both paths. The same run at lr 0 gives the
# initial weights' loss on each step's batch; at a tenth of the lr, Adam's
# first, sign-like updates move the wide layers a tenth as far, and no
# loss after them may exceed the lr-0 loss on its batch by more than
# LOW_LR_RTOL
RWKV_LOW_LR = 3e-5
LOW_LR_RTOL = 1e-2
LOSS_RTOL = 1e-5
# bf16 losses of the two paths at 8 layers: each rounds its activations to
# bf16 at other places (the WKV recurrence itself is float32 on both); a
# fault in a path moves the loss by O(1)
BF16_LOSS_RTOL = 1e-2
# rwkv6-7b 2-layer float32 gradients, kernel path (kernel forward) vs plain
# path (chunked forward), both with the chunked form's backward: each
# leaf's largest difference over its largest |g|
GRAD_TOL = 1e-3
DEVICE = "cuda"


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn(i) over `reps` calls, by CUDA
    events, after `warmup` calls."""
    import torch
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _busy_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _device_spans(torch, prof) -> list:
    """(start, end) in us of every device event of a torch.profiler run."""
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_ms(torch, fn, reps: int, warmup: int = 2):
    """Device time per call of fn(i): the union of the device events that
    torch.profiler records over `reps` calls, after `warmup` untraced ones,
    over `reps`. It leaves out the host's launch gaps that CUDA events over
    back-to-back calls include. None where the profiler records no device
    event (then the device time is not measured)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    busy = _busy_us(_device_spans(torch, prof))
    return busy / reps / 1e3 if busy else None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _bound(flops: float, nbytes: float, dtype_name: str) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _visible_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    total = 0
    for i in range(S):
        lo = 0 if window is None else max(0, i - window + 1)
        hi = i + 1 if causal else S
        total += hi - lo
    return total


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        raise SystemExit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    builds = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(builds)} kernels (all nvcc runs in parallel)")
    for b in builds.values():
        print(f"  {b.name}: {b.seconds:.1f} s -> {b.library.name}")
        for line in b.log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"    {line.strip()}")


def _bias(torch, valid):
    """Additive float32 mask: 0 where valid, -1e30 elsewhere."""
    return torch.full(valid.shape, -1e30, device=valid.device).masked_fill_(
        valid, 0.0)


def _randn(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _held(torch, out, gold, case, dt) -> dict:
    """`out` of a kernel against `gold`, its plain version run in float32
    on the same inputs: |out - gold| <= KERNEL_TOL + r |gold|, where r
    allows for the rounding of a bf16 output."""
    rel = BF16_OUT_REL if out.dtype == torch.bfloat16 else 0.0
    diff = (out.float() - gold).abs()
    over = (diff - rel * gold.abs()).max().item()
    return {"shape": list(case), "dtype": str(dt),
            "max_abs_err": diff.max().item(), "over_rel": over,
            "tol": f"{KERNEL_TOL} + {rel}|ref|", "ok": over <= KERNEL_TOL}


def phase_kernels(torch, seed: int) -> list:
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = _h2o()
    H, K, d, window = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.sliding_window)
    gen = torch.Generator(DEVICE).manual_seed(seed)

    # -- flash attention (prefill) --
    flash_cases = []
    h2o_flash = (BATCH, PROMPT, H, K, d, True, window)
    for dt in (torch.float32, torch.bfloat16):
        extra = FLASH_BF16_DIMS if dt == torch.bfloat16 else []
        for case in FLASH_SWEEP + extra + [h2o_flash]:
            B, S, Hc, Kc, dc, causal, win = case
            q = _randn(torch, gen, (B, S, Hc, dc), dt)
            k = _randn(torch, gen, (B, S, Kc, dc), dt)
            v = _randn(torch, gen, (B, S, Kc, dc), dt)
            o = fops.flash_attention(q, k, v, causal=causal, window=win)
            torch.cuda.synchronize()
            gold = flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=win)
            flash_cases.append(_held(torch, o, gold, case, dt))
            del gold
    q = _randn(torch, gen, (BATCH, PROMPT, H, d), torch.bfloat16)
    k = _randn(torch, gen, (BATCH, PROMPT, K, d), torch.bfloat16)
    v = _randn(torch, gen, (BATCH, PROMPT, K, d), torch.bfloat16)
    f_call = lambda i: fops.flash_attention(q, k, v, causal=True,  # noqa: E731
                                            window=window)
    f_ms = _time_ms(f_call, reps=10)
    f_plain = _time_ms(lambda i: flash_attention_ref(
        q, k, v, causal=True, window=window), reps=3, warmup=1)
    pos = torch.arange(PROMPT, device=DEVICE)
    dlt = pos[:, None] - pos[None, :]
    allowed = (dlt >= 0) & (dlt < window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    f_sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=allowed, enable_gqa=True)
    f_lib = _time_ms(f_sdpa, reps=5, warmup=1)
    f_dev = _device_ms(torch, f_call, reps=10)
    f_lib_dev = _device_ms(torch, f_sdpa, reps=5)
    pairs = _visible_pairs(PROMPT, True, window)
    f_bound, f_by = _bound(4.0 * BATCH * H * pairs * d,
                           2 * q.nbytes + k.nbytes + v.nbytes, "bfloat16")
    del q, k, v, qt, kt, vt, allowed

    # -- decode attention --
    decode_cases = []
    last = PROMPT + GEN - 1            # the last decode step's position
    slots = torch.arange(window, device=DEVICE)[None, :]
    kv_pos = last - ((last - slots) % window)
    ring = ((kv_pos >= 0) & (kv_pos <= last)).expand(BATCH, window)
    h2o_decode = (BATCH, window, H, K, d)
    # (q, cache) dtypes: float32, bf16, and a bf16 cache under float32 q
    for qt, ct in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.bfloat16)):
        for case in DECODE_SWEEP + [h2o_decode]:
            B, W, Hc, Kc, dc = case
            q = _randn(torch, gen, (B, 1, Hc, dc), qt)
            k = _randn(torch, gen, (B, W, Kc, dc), ct)
            v = _randn(torch, gen, (B, W, Kc, dc), ct)
            valid = (ring if case == h2o_decode else
                     torch.rand((B, W), generator=gen, device=DEVICE) < 0.8)
            bias = _bias(torch, valid)
            o = dops.decode_attention(q, k, v, bias)
            torch.cuda.synchronize()
            gold = decode_attention_ref(q.float(), k.float(), v.float(),
                                        bias)
            decode_cases.append(_held(
                torch, o, gold, case, qt if qt == ct else f"{qt}/{ct}"))
    # time over 8 caches (8 x 42 MB, beyond the 50 MB L2), as the 24 layers'
    # caches are cold when a decode step reaches them
    n_sets = 8
    q = _randn(torch, gen, (BATCH, 1, H, d), torch.bfloat16)
    ks = [_randn(torch, gen, (BATCH, window, K, d), torch.bfloat16)
          for _ in range(n_sets)]
    vs = [_randn(torch, gen, (BATCH, window, K, d), torch.bfloat16)
          for _ in range(n_sets)]
    bias = _bias(torch, ring)
    d_call = lambda i: dops.decode_attention(  # noqa: E731
        q, ks[i % n_sets], vs[i % n_sets], bias)
    d_ms = _time_ms(d_call, reps=80, warmup=8)
    d_plain = _time_ms(lambda i: decode_attention_ref(
        q, ks[i % n_sets], vs[i % n_sets], bias), reps=40, warmup=8)
    qt = q.transpose(1, 2)
    mask = bias[:, None, None, :]
    d_sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, ks[i % n_sets].transpose(1, 2), vs[i % n_sets].transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    d_lib = _time_ms(d_sdpa, reps=40, warmup=8)
    d_dev = _device_ms(torch, d_call, reps=40, warmup=8)
    d_lib_dev = _device_ms(torch, d_sdpa, reps=40, warmup=8)
    d_bound, d_by = _bound(4.0 * BATCH * H * window * d,
                           2 * q.nbytes + ks[0].nbytes + vs[0].nbytes
                           + bias.nbytes, "bfloat16")
    del ks, vs

    wkv = _wkv6_kernel(torch, gen)

    bad = []
    for name, cases in (("flash_attention", flash_cases),
                        ("decode_attention", decode_cases),
                        ("wkv6", wkv["cases"])):
        for c in cases:
            print(f"  {name} {c['dtype']:>14} {str(c['shape']):<40} "
                  f"max_abs_err {c['max_abs_err']:.3e}, beyond the "
                  f"relative part {c['over_rel']:.3e} (tol {c['tol']})")
            if not c.pop("ok"):
                bad.append((name, c["shape"], c["dtype"], c["over_rel"]))
    if bad:
        _fail(f"kernels disagree with their plain versions: {bad}")
    print(f"  flash_attention at {list(h2o_flash)} bf16: {f_ms:.4f} ms "
          f"(plain {f_plain:.3f} ms, SDPA {f_lib:.4f} ms, bound "
          f"{f_bound:.4f} ms by {f_by}); device only {_fmt(f_dev)} ms, "
          f"SDPA {_fmt(f_lib_dev)} ms")
    print(f"  decode_attention at {list(h2o_decode)} bf16: {d_ms:.4f} ms "
          f"(plain {d_plain:.4f} ms, SDPA {d_lib:.4f} ms, bound "
          f"{d_bound:.4f} ms by {d_by}); device only {_fmt(d_dev)} ms, "
          f"SDPA {_fmt(d_lib_dev)} ms")
    print(f"  wkv6 at {wkv['shape']} float32: {wkv['ms']:.4f} ms (plain "
          f"{wkv['plain_ms']:.3f} ms, no library call computes WKV6, bound "
          f"{wkv['bound_ms']:.4f} ms by {wkv['bound_by']}; device only "
          f"{_fmt(wkv['device_ms'])} ms); forward and "
          f"backward (the chunked form's autograd) "
          f"{wkv['fwd_bwd_ms'][0]:.1f} ms the first time, then "
          f"{wkv['fwd_bwd_ms'][1]:.1f} ms; gradient vs autograd of the "
          f"per-token plain version {wkv['grad_err']:.3e} of the largest "
          f"|g| (tol {WKV6_TOL})")
    if not wkv["grad_err"] <= WKV6_TOL:
        _fail(f"wkv6: gradient off by {wkv['grad_err']} of its largest |g|")
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:83",
         "launches": None, "max_abs_err": flash_cases[-1]["max_abs_err"],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": f_lib, "device_ms": f_dev,
         "library_device_ms": f_lib_dev,
         "shape": list(h2o_flash), "cases": flash_cases},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/"
                     "decode_attention.py:55",
         "launches": None, "max_abs_err": decode_cases[-1]["max_abs_err"],
         "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": d_lib, "device_ms": d_dev,
         "library_device_ms": d_lib_dev,
         "shape": list(h2o_decode), "cases": decode_cases},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6/rwkv6.py:70",
         "launches": None, "max_abs_err": wkv["cases"][-1]["max_abs_err"],
         "ms": wkv["ms"], "plain_ms": wkv["plain_ms"],
         "bound_ms": wkv["bound_ms"], "bound_by": wkv["bound_by"],
         "library_ms": None, "device_ms": wkv["device_ms"],
         "library_device_ms": None,
         "library_note": "no PyTorch call computes the WKV6 recurrence",
         "shape": wkv["shape"], "grad_err": wkv["grad_err"],
         "fwd_bwd_ms": wkv["fwd_bwd_ms"],
         "cases": wkv["cases"]},
    ]


def _wkv6_inputs(torch, gen, B, H, S, d):
    """r, k, v, logw (B,H,S,d), u (H,d), float32, scaled as the
    reference's sweep: logw = -exp(N(0,1)/2 - 1)."""
    r, k, v = (_randn(torch, gen, (B, H, S, d), torch.float32) * 0.5
               for _ in range(3))
    logw = -torch.exp(_randn(torch, gen, (B, H, S, d), torch.float32) * 0.5
                      - 1.0)
    return r, k, v, logw, _randn(torch, gen, (H, d), torch.float32) * 0.5


def _wkv6_kernel(torch, gen) -> dict:
    """wkv6 against wkv6_ref on the card: the sweep, the strong-decay
    cases and rwkv6-7b's training shape; its gradient at one sweep shape;
    times and bound at the training shape."""
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    cfg = _config(RWKV)
    _, B, S, _ = RWKV_TRAIN
    H, d = cfg.d_model // cfg.head_dim_(), cfg.head_dim_()
    shape = (B, H, S, d)

    def held(case, inputs, rtol=0.0):
        o, s = wops.wkv6(*inputs)
        torch.cuda.synchronize()
        ro, rs = wkv6_ref(*inputs, torch.zeros_like(s))
        over = max(((a - b).abs() - rtol * b.abs()).max().item()
                    for a, b in ((o, ro), (s, rs)))
        err = max((a - b).abs().max().item() for a, b in ((o, ro), (s, rs)))
        finite = bool(torch.isfinite(o).all() and torch.isfinite(s).all())
        return {"shape": list(case), "dtype": "torch.float32",
                "max_abs_err": err, "over_rel": over,
                "tol": f"{WKV6_TOL} + {rtol}|ref|",
                "ok": finite and over <= WKV6_TOL}

    cases = []
    for case in WKV6_SWEEP:
        cases.append(held(case, _wkv6_inputs(torch, gen, *case)))
    for logw in (-30.0, -1e-6):
        r, k, v = (_randn(torch, gen, (1, 1, 128, 32), torch.float32)
                   for _ in range(3))
        c = held((1, 1, 128, 32), (r, k, v, torch.full_like(r, logw),
                                   torch.zeros((1, 32), device=DEVICE)),
                 rtol=WKV6_STABLE_RTOL)
        cases.append(dict(c, logw=logw))
    inputs = _wkv6_inputs(torch, gen, *shape)
    cases.append(held(shape, inputs))

    # the gradient through the kernel's autograd.Function (autograd of the
    # chunked form) against autograd of the per-token plain version
    small = [x.requires_grad_() for x in _wkv6_inputs(torch, gen,
                                                      *WKV6_SWEEP[1])]
    g_o = _randn(torch, gen, small[0].shape, torch.float32)
    got = torch.autograd.grad(wops.wkv6(*small)[0], small, g_o)
    d1 = small[0].shape[-1]
    ref_o, _ = wkv6_ref(*small, torch.zeros(small[0].shape[:2] + (d1, d1),
                                            device=DEVICE))
    want = torch.autograd.grad(ref_o, small, g_o)
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(got, want))

    ms = _time_ms(lambda i: wops.wkv6(*inputs), reps=10)
    device_ms = _device_ms(torch, lambda i: wops.wkv6(*inputs), reps=10)
    # one layer's train-path WKV6: the kernel's forward and the backward
    # (the chunked form recomputed under autograd); the first call, which
    # also pays the caching allocator's first allocation of the chunked
    # form's saved tensors, and a second one
    live = [x.detach().requires_grad_() for x in inputs]
    g = torch.ones_like(inputs[0])
    train_ms = [_time_ms(lambda i: torch.autograd.grad(
        wops.wkv6(*live)[0], live, g), reps=1, warmup=0) for _ in range(2)]
    del live, g
    zero = torch.zeros(shape[:2] + (d, d), device=DEVICE)
    plain_ms = _time_ms(lambda i: wkv6_ref(*inputs, zero), reps=2, warmup=1)
    # each of r, k, v, logw read once, o written once, u read, S_final
    # written; 5 FLOP per state entry per token (the o product's
    # multiply-add, the decay's multiply, k v^T's multiply and the add)
    nbytes = 5 * inputs[0].nbytes + inputs[4].nbytes + zero.nbytes
    bound_ms, bound_by = _bound(5.0 * B * H * S * d * d, nbytes, "float32")
    return {"cases": cases, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": list(shape), "grad_err": grad_err,
            "fwd_bwd_ms": train_ms, "device_ms": device_ms}


def _config(arch, **replace):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **replace)


def _h2o():
    return _config(ARCH)


def phase_serve(torch, seed: int, card: str) -> dict:
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    cfg = _h2o()
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    prompts = torch.randint(
        0, cfg.vocab_size, (BATCH, PROMPT), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 1))
    torch.cuda.reset_peak_memory_stats()

    fops.flash_attention.launches = 0
    dops.decode_attention.launches = 0
    tokens, stats, logits = serve(cfg, batch=BATCH, prompt_len=PROMPT,
                                  gen=GEN, seed=seed, use_kernels=True,
                                  device=DEVICE, params=params,
                                  prompts=prompts)
    launches = {"flash_attention": fops.flash_attention.launches,
                "decode_attention": dops.decode_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * (GEN - 1)}
    print(f"  launches {launches} (expected {want})")
    if launches != want:
        _fail(f"serve launched {launches}, expected {want}")
    Vp = cfg.padded_vocab()
    if tuple(tokens.shape) != (BATCH, GEN) or tuple(logits.shape) != (
            BATCH, GEN, Vp):
        _fail(f"shapes: tokens {tuple(tokens.shape)}, logits "
              f"{tuple(logits.shape)}")
    if not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        _fail("generated token ids out of the vocabulary")
    if not bool(torch.isfinite(logits).all()):
        _fail("non-finite logits on the kernel path")

    # The kernel path against the plain path, both teacher-forced with the
    # kernel path's tokens, and a float32 run of the same model as the
    # yardstick for the two bf16 paths.
    plain, plain_s = _teacher_forced(cfg, params, prompts, tokens, False,
                                     torch.bfloat16)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = _cast(params, torch.float32)
    gold, _ = _teacher_forced(cfg32, params32, prompts, tokens, False,
                              torch.float32)
    kern32, _ = _teacher_forced(cfg32, params32, prompts, tokens, True,
                                torch.float32)
    del params32

    def err(a, b):         # max |a - b| at each position: (GEN,)
        return (a - b).abs().amax(dim=(0, 2))

    def rms(a, b):
        return (a - b).square().mean().sqrt().item()
    e_f32 = err(kern32, gold)
    e_kernel, e_plain = err(logits, gold), err(plain, gold)
    excess = (e_kernel - e_plain).max().item()
    rms_ratio = rms(logits, gold) / rms(plain, gold)
    print(f"  float32, kernel path vs plain path: max |dlogit| "
          f"{e_f32.max().item():.3e} (tol {LOGIT_TOL_F32})")
    print(f"  bf16 vs the float32 plain path: max |dlogit| kernel path "
          f"{e_kernel.max().item():.4f}, plain path "
          f"{e_plain.max().item():.4f}; RMS kernel path "
          f"{rms(logits, gold):.5f}, plain path {rms(plain, gold):.5f}; "
          f"kernel path vs plain path {err(logits, plain).max().item():.4f} "
          f"(prefill {err(logits, plain)[0].item():.4f})")
    print(f"  bf16 kernel-path excess over the plain path: largest per "
          f"position {excess:.4f} (tol {BF16_EXCESS_TOL}), RMS ratio "
          f"{rms_ratio:.4f} (tol {BF16_RMS_RATIO})")
    if not e_f32.max().item() <= LOGIT_TOL_F32:
        _fail(f"float32: the kernel path's logits differ from the plain "
              f"path's by {e_f32.max().item()} > {LOGIT_TOL_F32}")
    if not excess <= BF16_EXCESS_TOL:
        _fail(f"bf16: the kernel path is {excess} farther from float32 than "
              f"the plain path at some position (tol {BF16_EXCESS_TOL})")
    if not rms_ratio <= BF16_RMS_RATIO:
        _fail(f"bf16: the kernel path's RMS logit error is {rms_ratio} times "
              f"the plain path's (tol {BF16_RMS_RATIO})")
    print(f"  serve {ARCH} ({cfg.num_layers} layers, bf16) batch {BATCH} "
          f"prompt {PROMPT} "
          f"gen {GEN} on {card}: prefill "
          f"{stats['prefill_tokens_per_s']:.1f} tok/s "
          f"({stats['prefill_s']:.4f} s), decode "
          f"{stats['decode_tokens_per_s']:.1f} tok/s "
          f"({stats['decode_s']:.4f} s; first step "
          f"{stats['decode_first_step_s'] * 1e3:.2f} ms, steady "
          f"{stats['decode_steady_step_s'] * 1e3:.2f} ms/step = "
          f"{stats['decode_steady_tokens_per_s']:.1f} tok/s); plain path "
          f"prefill {BATCH * PROMPT / plain_s[0]:.1f} tok/s, decode "
          f"{BATCH * (GEN - 1) / plain_s[1]:.1f} tok/s; peak memory of the "
          f"kernel path {peak_gb:.2f} GB")
    prof = _profile_decode(torch, cfg, params, prompts, tokens,
                           stats["decode_steady_step_s"])
    return launches, dict(stats, profile=prof)


def _profile_decode(torch, cfg, params, prompts, tokens, steady_s) -> dict:
    """Trace PROFILE_STEPS kernel-path decode steps (after two untraced
    ones) with torch.profiler: device busy time and device events per step,
    the kernels that take most of it, and the device's idle share against
    the untraced steady decode step `steady_s`."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill, make_serve_step
    caches = M.init_caches(cfg, BATCH, PROMPT + GEN, device=DEVICE)
    prefill = make_prefill(cfg)
    step = make_serve_step(cfg)
    with torch.no_grad():
        _, caches = prefill(params, caches, {"tokens": prompts})
        for t in range(1, 3):
            _, caches, _ = step(params, caches, tokens[:, t - 1:t])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(3, 3 + PROFILE_STEPS):
                _, caches, _ = step(params, caches, tokens[:, t - 1:t])
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
    spans, by_name = _device_spans(torch, prof), {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.time_range.elapsed_us()
    busy_us = _busy_us(spans)
    out = {"steps": PROFILE_STEPS, "traced_step_ms":
           traced_s / PROFILE_STEPS * 1e3,
           "device_events_per_step": len(spans) / PROFILE_STEPS}
    if not spans:
        print("  decode profile: device time not measured (the profiler "
              "recorded no device events)")
        return dict(out, device_busy_ms_per_step=None, idle_share=None)
    busy_ms = busy_us / PROFILE_STEPS / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out.update(device_busy_ms_per_step=busy_ms,
               idle_share=1.0 - busy_ms / (steady_s * 1e3),
               top_device_ms_per_step={
                   n: us / PROFILE_STEPS / 1e3 for n, us in top})
    print(f"  decode profile ({PROFILE_STEPS} steps, torch.profiler): "
          f"{out['device_events_per_step']:.0f} device events and "
          f"{busy_ms:.3f} ms device busy per step; traced step "
          f"{out['traced_step_ms']:.2f} ms, untraced steady step "
          f"{steady_s * 1e3:.2f} ms: idle share {out['idle_share']:.4f}")
    for n, ms in out["top_device_ms_per_step"].items():
        print(f"    {ms:.4f} ms/step  {n[:90]}")
    return out


def _device_batch(torch, cfg, batch, seq, step, seed):
    """The train driver's data for `step`: the storage-node dataset made
    from `seed`, on the card."""
    from repro_torch.data.pipeline import StorageNodeDataset
    ds = StorageNodeDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                            global_batch=batch, seed=seed,
                            distribution="zipf_markov")
    return {k: torch.from_numpy(v).to(DEVICE)
            for k, v in ds.fetch_step(step).items()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def phase_train(torch, seed: int, card: str) -> tuple:
    """The three train checks; returns (launches by kernel and path, the
    train block of the result line)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6 import ops as wops
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.train.steps import make_grad_fn, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    launches, out = {}, {}

    # (a) lovelock-20m, float32, 3 steps through both paths
    arch, B, S, steps = LOVELOCK
    cfg = _config(arch, param_dtype="float32", compute_dtype="float32")
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    batches = [_device_batch(torch, cfg, B, S, i, seed) for i in range(steps)]
    oc = OptimizerConfig(warmup=10, total_steps=steps)
    losses = {}
    for use_kernels in (True, False):
        state = adamw_init(tree_map(lambda p: p.clone(), params), oc)
        step = make_train_step(cfg, oc, use_kernels=use_kernels)
        fops.flash_attention.launches = 0
        losses[use_kernels] = []
        for b in batches:
            state, metrics = step(state, b)
            losses[use_kernels].append(float(metrics["loss"]))
        n = fops.flash_attention.launches
        # one launch per layer in the forward, one more in remat's recompute
        want = cfg.num_layers * 2 * steps if use_kernels else 0
        print(f"  {arch} float32 {B}x{S}, {steps} steps, "
              f"{'kernel' if use_kernels else 'plain'} path: losses "
              f"{losses[use_kernels]}, flash launches {n} (expected {want})")
        if n != want:
            _fail(f"{arch} train: flash launched {n}, expected {want}")
        if use_kernels:
            launches[f"train {arch}"] = n
    rel = max(_rel(a, b) for a, b in zip(losses[True], losses[False]))
    print(f"  {arch}: kernel vs plain path losses {rel:.3e} relative "
          f"(tol {LOSS_RTOL})")
    if not rel <= LOSS_RTOL:
        _fail(f"{arch} train: losses differ by {rel} relative")
    out[arch] = {"batch": B, "seq": S, "dtype": "float32",
                 "losses_kernel": losses[True],
                 "losses_plain": losses[False], "loss_rel_err": rel}
    del params, batches, state

    # (b) rwkv6-7b at full width, 2 layers, float32: loss and gradients
    layers, B, S = RWKV_PARITY
    cfg = _config(RWKV, num_layers=layers, param_dtype="float32",
                  compute_dtype="float32")
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    batch = _device_batch(torch, cfg, B, S, 0, seed)
    got = {}
    for use_kernels in (True, False):
        wops.wkv6.launches = 0
        metrics, grads = make_grad_fn(cfg, use_kernels=use_kernels)(params,
                                                                    batch)
        got[use_kernels] = (float(metrics["loss"]), tree_leaves(grads))
        n = wops.wkv6.launches
        want = layers * 2 if use_kernels else 0
        if n != want:
            _fail(f"{RWKV} {layers}-layer gradient: wkv6 launched {n}, "
                  f"expected {want}")
    rel = _rel(got[True][0], got[False][0])
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(got[True][1], got[False][1]))
    print(f"  {RWKV} {layers} layers float32 {B}x{S}: loss "
          f"{got[True][0]:.6f} (plain {got[False][0]:.6f}, {rel:.3e} "
          f"relative, tol {LOSS_RTOL}); gradients: largest leaf difference "
          f"{grad_err:.3e} of its largest |g| (tol {GRAD_TOL})")
    if not rel <= LOSS_RTOL:
        _fail(f"{RWKV} {layers}-layer loss differs by {rel} relative")
    if not grad_err <= GRAD_TOL:
        _fail(f"{RWKV} {layers}-layer gradients differ by {grad_err}")
    out[f"{RWKV} {layers} layers"] = {
        "batch": B, "seq": S, "dtype": "float32", "loss_kernel": got[True][0],
        "loss_plain": got[False][0], "loss_rel_err": rel,
        "grad_rel_err": grad_err, "wkv6_launches": layers * 2}
    del params, batch, got, grads
    torch.cuda.empty_cache()

    # (c) rwkv6-7b at full width, 8 of 32 layers, bf16, through train_loop
    layers, B, S, steps = RWKV_TRAIN
    cfg = _config(RWKV, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    wops.wkv6.launches = 0
    state, info = train_loop(cfg, steps=steps, batch=B, seq=S, seed=seed,
                             log_every=1, use_kernels=True, device=DEVICE)
    n = wops.wkv6.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = layers * 2 * steps
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    del state
    torch.cuda.empty_cache()
    step_s = info["step_s"]
    steady = sum(step_s[1:]) / len(step_s[1:])
    print(f"  {RWKV} {layers} layers bf16 {B}x{S}, {steps} steps through "
          f"train_loop on {card}: {n_params / 1e9:.3f} B params, losses "
          f"{info['losses']}, step s {step_s} (first {step_s[0]:.3f}, "
          f"steady {steady:.3f} = {B * S / steady:.1f} tok/s), peak memory "
          f"{peak_gb:.2f} GB, wkv6 launches {n} (expected {want})")
    if n != want:
        _fail(f"{RWKV} train: wkv6 launched {n}, expected {want}")
    if not all(math.isfinite(x) for x in info["losses"]):
        _fail(f"{RWKV} train: non-finite loss {info['losses']}")
    launches[f"train {RWKV} {layers} layers"] = n
    # the same run through the plain path (chunked WKV6 and its autograd
    # backward): the losses side by side
    torch.cuda.reset_peak_memory_stats()
    plain = train_loop(cfg, steps=steps, batch=B, seq=S, seed=seed,
                       log_every=steps, use_kernels=False,
                       device=DEVICE)[1]           # the state is not kept
    plain_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    rel = _rel(info["losses"][0], plain["losses"][0])
    plain_steady = sum(plain["step_s"][1:]) / len(plain["step_s"][1:])
    print(f"  the same run through the plain path: losses "
          f"{plain['losses']} (first {rel:.3e} relative to the kernel "
          f"path's, tol {BF16_LOSS_RTOL}), step s {plain['step_s']} "
          f"(steady {plain_steady:.3f}), peak memory {plain_peak_gb:.2f} GB")
    if not all(math.isfinite(x) for x in plain["losses"]):
        _fail(f"{RWKV} train, plain path: non-finite loss {plain['losses']}")
    if not rel <= BF16_LOSS_RTOL:
        _fail(f"{RWKV} train: first losses of the paths differ by {rel}")
    # the kernel path again at lr 0 and at a tenth of the lr: each step's
    # loss against the initial weights' loss on the same batch
    probe = {lr: train_loop(cfg, steps=steps, batch=B, seq=S, seed=seed,
                            log_every=steps, lr=lr, use_kernels=True,
                            device=DEVICE)[1]["losses"]
             for lr in (0.0, RWKV_LOW_LR)}
    torch.cuda.empty_cache()
    base = probe[0.0]
    ratios = {lr: [a / b for a, b in zip(losses, base)] for lr, losses in
              ((RWKV_LOW_LR, probe[RWKV_LOW_LR]), (3e-4, info["losses"]))}
    print(f"  the kernel path at lr 0: losses {base}; at lr {RWKV_LOW_LR}: "
          f"{probe[RWKV_LOW_LR]}. Each step's loss over the lr-0 loss on its "
          f"batch: {ratios[RWKV_LOW_LR]} at lr {RWKV_LOW_LR} (tol "
          f"{1 + LOW_LR_RTOL}), {ratios[3e-4]} at the default lr")
    if not (all(math.isfinite(x) for x in base + probe[RWKV_LOW_LR])
            and max(ratios[RWKV_LOW_LR]) <= 1 + LOW_LR_RTOL):
        _fail(f"{RWKV} train at lr {RWKV_LOW_LR}: losses "
              f"{probe[RWKV_LOW_LR]} against {base} at lr 0")
    out[f"{RWKV} {layers} layers"] = {
        "batch": B, "seq": S, "dtype": "bfloat16", "params": n_params,
        "losses": info["losses"], "step_s": step_s,
        "first_step_s": step_s[0], "steady_step_s": steady,
        "tokens_per_s": B * S / steady, "peak_memory_gb": peak_gb,
        "plain_path": {"losses": plain["losses"], "step_s": plain["step_s"],
                       "first_loss_rel_err": rel,
                       "peak_memory_gb": plain_peak_gb},
        "losses_by_lr": {str(lr): v for lr, v in probe.items()},
        "loss_over_lr0": {str(lr): v for lr, v in ratios.items()}}
    return launches, out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _teacher_forced(cfg, params, prompts, tokens, use_kernels, cache_dtype):
    """Prefill `prompts`, then decode feeding `tokens[:, :-1]`: the logits
    (B, GEN, Vp) float32 at each position, and (prefill s, decode s)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill, make_serve_step
    caches = M.init_caches(cfg, BATCH, PROMPT + GEN, dtype=cache_dtype,
                           device=DEVICE)
    prefill = make_prefill(cfg, use_kernels=use_kernels)
    step = make_serve_step(cfg, use_kernels=use_kernels)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = prefill(params, caches, {"tokens": prompts})
        out = [lg[:, -1].float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(1, GEN):
            _, caches, last = step(params, caches, tokens[:, t - 1:t])
            out.append(last.float())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return torch.stack(out, dim=1), (t1 - t0, t2 - t1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    print("== card")
    card = phase_card(torch)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    print("== build")
    phase_build(_build)
    print("== kernels")
    kernels = phase_kernels(torch, args.seed)
    print("== serve")
    launches, serve_stats = phase_serve(torch, args.seed, card)
    print("== train")
    train_launches, train_stats = phase_train(torch, args.seed, card)
    by_path = {"flash_attention": {f"serve {ARCH}":
                                   launches["flash_attention"]},
               "decode_attention": {f"serve {ARCH}":
                                    launches["decode_attention"]},
               "wkv6": {}}
    for path, n in train_launches.items():
        by_path["wkv6" if RWKV in path else "flash_attention"][path] = n
    for k in kernels:
        # each main path's own count, reset to 0 just before its run and
        # read just after; `launches` is the first such path's
        paths = by_path[k["name"]]
        k["launches_path"], k["launches"] = next(iter(paths.items()))
        k["launches_by_path"] = paths
    print(json.dumps({"kernels": kernels, "card": card,
                      "serve": serve_stats, "train": train_stats}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
