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
              torch.profiler; flash and decode attention also at the
              shapes jamba-v0.1-52b's serve run gives them (d = 128,
              G = 4, causal with no window; a 4,128-slot cache), at
              whisper-large-v3's (encoder flash non-causal over 1500
              frames, G = 1, d = 64; decode over 256 slots) and at
              llama-3.2-vision-90b's (flash G = 8, d = 128, causal over
              4096; decode over 4,128 slots, also with a float32 q, the
              route its float32 gate takes); flash is also held at the
              distributed phase's train shapes (h2o-danube-1.8b at
              4 x 2048 and 4 x 512) in both dtypes;
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
5. serve-hybrid -- serve jamba-v0.1-52b at full width, one period (8
              of 32 layers: Mamba, MoE and one attention layer; random bf16
              weights from --seed): batch 4, prompt 4096, 32 generated
              tokens, through the kernels; check the launch counts (one
              flash launch, 31 decode launches). Teacher-force the same
              tokens through the plain path in bf16, recording every
              expert choice of both paths: no choice may differ upstream
              of the attention layer (the paths run the same code there),
              at most HY_FLIP_SHARE of all (token, layer, k) choices may
              differ, and at the positions whose own choices agree in
              every MoE layer (at least half of them) the logits may
              differ by at most HY_AGREE_TOL. A flipped near-tie moves a
              token's output by O(1), so the excess-over-float32 gate of
              phase 4 does not apply. Then the prefill's time by layer
              function (CUDA events) and its top device ops
              (torch.profiler), the decode step's idle share, and, with
              the bf16 weights freed, the float32 gate: batch 1, prompt
              1024, 8 decode steps through both paths, logits within 1e-4
              at every position and identical expert choices;
6. serve-xattn -- (a) whisper-large-v3 whole (32 encoder and 32
              decoder layers, random bf16 weights from --seed): batch 4,
              1500 random N(0,1) frames, prompt 224, 32 tokens through the
              kernels (64 flash and 992 decode launches; the encoder's
              time by CUDA events); the same tokens teacher-forced
              through the plain path in bf16 and through both paths in
              float32: phase 4's gates and limits (float32 within 1e-4
              at every position; the bf16 excess and RMS ratio);
              liveness: zeroed frames move the float32 logits by at least
              LIVE_MIN. (b) llama-3.2-vision-90b at full width, one
              period (5 of 100 layers), the cross-attention gate at
              XA_GATE: batch 4, 1601 random N(0,1) image embeddings,
              prompt 4096, 32 tokens (4 flash and 124 decode launches);
              then at batch 1, prompt 1024, 8 decode steps: phase 4's
              bf16 excess gate, and, with the bf16 weights freed, the float32
              gate and liveness (gate 0 against XA_GATE). For both: the
              prefill by layer function, its top device ops and the
              decode step's idle share;
7. train   -- (a) lovelock-20m at full size in float32: 3 train steps
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
8. distributed -- the sharded train step on a world-1 NCCL group (a
              FileStore under build/; one card is one rank): (a) h2o-danube
              -1.8b at full width cut to 2 layers, float32, DIST_F32, on a
              (1, 1) ("data", "model") mesh against the meshless step:
              losses within 1e-5 relative, params within DIST_PARAM_TOL of
              the largest |p|; then h2o-danube-1.8b whole (24 layers) in
              bf16, DIST, on the (1, 1) mesh (state placed by
              state_specs) and again without a mesh from the same seed and
              batches, with the reference's test optimizer (lr DIST_LR):
              finite losses within DIST_LOSS_RTOL, the flash kernel
              launched as often (24 x 2 a step). (b) the same model on a
              (1, 1, 1) ("pod", "data", "model") mesh with
              grad_sync="compressed_pod": losses within COMPRESSED_TOL of
              (a)'s meshed run, every ef leaf finite and some nonzero, and
              quantized_psum_pod on the largest gradient leaf bit-equal to
              a numpy re-enactment in float32 of the reference's math;
              then the compressed run against its arithmetic with no mesh
              (`_compressed_replay`): losses within LOSS_RTOL.
              (c) lovelock-20m float32 through ElasticRunner: 12 batches,
              a checkpoint every 4 under build/, a failure at step 6: one
              recovery, final params within DIST_PARAM_TOL of an
              uninterrupted run's. (d) flat_all_reduce and
              hierarchical_all_reduce at world 1 equal their input's sum.
              Step times (first, steady), tokens/s and peak memory of each
              run of (a) and (b), and the meshed step's host overhead;
9. checkpoint -- (a) lovelock-20m in float32 through the kernel path:
              4 steps of `train_loop` with a checkpoint every 2, the last
              checkpoint removed, then a fresh `train_loop(resume=True)`
              runs steps 3-4: losses within RESUME_RTOL of the straight
              run's. (b) h2o-danube-1.8b's full-width bf16 params written
              by the streaming checkpointer under build/ and read back
              onto the card bit for bit, with write and read GB/s and at
              most `buffers` x `chunk` bytes in flight; then deleted;
10. result -- print the kernels' JSON line, then the device line.
"""
from __future__ import annotations

import argparse
import contextlib
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
# the hybrid serve run: jamba-v0.1-52b at full width, one period (8 of its
# 32 layers: 13.3 B parameters, 26.6 GB in bf16; all 32 do not fit one
# 80 GB card), batch BATCH, prompt 4096 (a whole number of the Mamba scan's
# 256-token chunks), GEN generated tokens
HYBRID, HY_LAYERS, HY_PROMPT = "jamba-v0.1-52b", 8, 4096
# its float32 gate, kernel path vs plain path: batch 1, prompt 1024 and 8
# decode steps (fewer than GEN, to keep the phase short)
HY_F32 = (1, 1024, 8)
# its bf16 gate, kernel path vs plain path (PERF.md): a routing choice that
# flips on a near-tie moves its token's output by O(1), so the gate bounds
# the share of (token, layer, k) choices that differ, and the logit gap at
# positions whose own choices agree in every MoE layer. Limits about ten
# and three times the first full run's readings on the H100; a fault in
# the attention path would flip a large share of the choices after it
HY_FLIP_SHARE = 2e-3       # read: 2.120e-04 (28 of 132,064)
HY_AGREE_TOL = 0.1         # read: 0.0312 (128 of 128 positions agreeing)
TOP_OPS = 12               # device ops of the prefill listed
# the cross-attention serve runs (phase serve-xattn): whisper-large-v3
# whole (32 encoder and 32 decoder layers, 2.02 B parameters, 4.04 GB in
# bf16), batch BATCH, its 1500 audio frames random N(0,1), prompt 224 (half
# of its 448-token text context), GEN tokens; llama-3.2-vision-90b at full
# width, one period (5 of 100 layers: 4 self-attention, 1 gated
# cross-attention; 6.38 B parameters, 12.76 GB in bf16; all 100 layers do
# not fit one 80 GB card), prompt 4096, its 1601 image embeddings random
# N(0,1), the cross-attention gate set to XA_GATE (it starts at 0, where
# tanh(0) = 0 would leave the layer dead)
WHISPER, WH_PROMPT = "whisper-large-v3", 224
VLM, VLM_LAYERS, VLM_PROMPT = "llama-3.2-vision-90b", 5, 4096
XA_GATE = 1.0
# the VLM's gates: batch 1, prompt 1024, 8 decode steps (the plain path's
# float32 self-attention scores at 4 x 4096 would need ~34 GB more)
VLM_GATES = (1, 1024, 8)
# liveness of the cross path: zeroed frames (whisper) or a zero gate (the
# VLM) must move the float32 logits by at least this, 100 times the
# float32 gate's tolerance
LIVE_MIN = 100 * LOGIT_TOL_F32
# the checkpoint phase: resume through train_loop (arch, batch, seq,
# steps, checkpoint every), held to RESUME_RTOL; then h2o-danube-1.8b's
# params written and read back
CKPT_RESUME = ("lovelock-20m", 8, 256, 4, 2)
RESUME_RTOL = 1e-6
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
# the distributed phase: h2o-danube-1.8b at full width and depth, bf16,
# batch x seq tokens, `steps` steps through the sharded step on a world-1
# NCCL group (one card is one rank; multi-rank runs are the CPU tests')
DIST = (4, 2048, 3)                       # batch, seq, steps
DIST_F32 = (2, 4, 512, 3)                 # layers, batch, seq, steps
# bf16 losses, meshed vs meshless: the same kernels on the same data, the
# mesh's collectives at world 1 are copies; a fault moves the loss by O(1)
DIST_LOSS_RTOL = 1e-2
# compressed vs gspmd losses: the reference's own bound, with its test's
# optimizer, OptimizerConfig(lr=1e-3): warmup 100, so steps of lr 1e-5,
# 2e-5, 3e-5 (tests/test_distributed.py:88-119). The reference set it at
# smoke size, where a step moves the loss by ~0.03; here a step moves it by
# ~0.7-0.9 and the gap grows with it: 0.0468 at seed 0, 0.0685, 0.0614 and
# 0.0491 at seeds 1-3 (tools/dist_probe.py, PERF.md; ROADMAP.md section 3).
# What holds the port's compressed step to the reference's arithmetic is
# the replay gate after it. train_loop's schedule (lr 3e-4, warmup 10) is
# tools/dist_probe.py's too
COMPRESSED_TOL = 0.05
DIST_LR = 1e-3
# float32 params after the (1, 1) mesh's steps against the meshless
# steps', over the largest |p|
DIST_PARAM_TOL = 1e-6
# ElasticRunner: arch, batch, seq, batches, checkpoint every, failure at
ELASTIC = ("lovelock-20m", 8, 256, 12, 4, 6)
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


def _ring_valid(torch, B, W, last):
    """(B, W) validity of a ring cache of W slots after position `last`
    was written (unwritten slots have negative positions)."""
    slots = torch.arange(W, device=DEVICE)[None, :]
    kv_pos = last - ((last - slots) % W)
    return ((kv_pos >= 0) & (kv_pos <= last)).expand(B, W)


def _flash_times(torch, gen, case) -> dict:
    """The bf16 flash kernel at `case` (B, S, H, K, d, causal, window):
    CUDA events, device-only (torch.profiler), the plain version, SDPA
    (events and device-only) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, S, H, K, d, causal, window = case
    q = _randn(torch, gen, (B, S, H, d), torch.bfloat16)
    k = _randn(torch, gen, (B, S, K, d), torch.bfloat16)
    v = _randn(torch, gen, (B, S, K, d), torch.bfloat16)
    f_call = lambda i: fops.flash_attention(q, k, v, causal=causal,  # noqa: E731
                                            window=window)
    ms = _time_ms(f_call, reps=10)
    plain = _time_ms(lambda i: flash_attention_ref(
        q, k, v, causal=causal, window=window), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        f_sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    else:
        pos = torch.arange(S, device=DEVICE)
        dlt = pos[:, None] - pos[None, :]
        allowed = (dlt < window) & ((dlt >= 0) if causal else True)
        f_sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=allowed, enable_gqa=True)
    lib = _time_ms(f_sdpa, reps=5, warmup=1)
    dev = _device_ms(torch, f_call, reps=10)
    lib_dev = _device_ms(torch, f_sdpa, reps=5)
    bound, by = _bound(4.0 * B * H * _visible_pairs(S, causal, window) * d,
                       2 * q.nbytes + k.nbytes + v.nbytes, "bfloat16")
    return {"shape": list(case), "dtype": str(q.dtype), "ms": ms,
            "plain_ms": plain,
            "library_ms": lib, "device_ms": dev, "library_device_ms": lib_dev,
            "bound_ms": bound, "bound_by": by}


def _decode_times(torch, gen, case, valid, qt=None, ct=None) -> dict:
    """The decode kernel at `case` (B, W, H, K, d) with the (B, W) mask
    `valid`, q of dtype `qt` and caches of `ct` (both bf16 by default),
    over 8 caches (beyond the 50 MB L2 when a cache is more than 6 MB, as
    each layer's cache is cold when a decode step reaches it): CUDA
    events, device-only, the plain version, SDPA and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    B, W, H, K, d = case
    qt, ct = qt or torch.bfloat16, ct or torch.bfloat16
    n_sets = 8
    q = _randn(torch, gen, (B, 1, H, d), qt)
    ks = [_randn(torch, gen, (B, W, K, d), ct) for _ in range(n_sets)]
    vs = [_randn(torch, gen, (B, W, K, d), ct) for _ in range(n_sets)]
    bias = _bias(torch, valid)
    d_call = lambda i: dops.decode_attention(  # noqa: E731
        q, ks[i % n_sets], vs[i % n_sets], bias)
    ms = _time_ms(d_call, reps=80, warmup=8)
    plain = _time_ms(lambda i: decode_attention_ref(
        q, ks[i % n_sets], vs[i % n_sets], bias), reps=40, warmup=8)
    q_t = q.transpose(1, 2)
    mask = bias[:, None, None, :]
    # SDPA takes one dtype: under a float32 q it reads float32 copies of a
    # bf16 cache (made here, not timed)
    ks_t, vs_t = ([x.to(qt).transpose(1, 2) for x in xs] for xs in (ks, vs))
    d_sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q_t, ks_t[i % n_sets], vs_t[i % n_sets], attn_mask=mask,
        enable_gqa=True)
    lib = _time_ms(d_sdpa, reps=40, warmup=8)
    dev = _device_ms(torch, d_call, reps=40, warmup=8)
    lib_dev = _device_ms(torch, d_sdpa, reps=40, warmup=8)
    # a float32 q runs on the CUDA cores in float32
    bound, by = _bound(4.0 * B * H * W * d,
                       2 * q.nbytes + ks[0].nbytes + vs[0].nbytes
                       + bias.nbytes, str(qt).removeprefix("torch."))
    return {"shape": list(case), "dtype": str(qt) if qt == ct
            else f"{qt}/{ct}", "ms": ms, "plain_ms": plain,
            "library_ms": lib, "device_ms": dev, "library_device_ms": lib_dev,
            "bound_ms": bound, "bound_by": by}


def _case_err(cases, case, dtype) -> float:
    """max_abs_err of the held case of shape `case` and dtype `dtype`."""
    return next(c["max_abs_err"] for c in cases
                if c["shape"] == list(case) and c["dtype"] == str(dtype))


def phase_kernels(torch, seed: int) -> list:
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    cfg = _h2o()
    H, K, d, window = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                       cfg.sliding_window)
    hy = _hybrid()
    wh, vlm = _config(WHISPER), _config(VLM)
    gen = torch.Generator(DEVICE).manual_seed(seed)

    # -- flash attention (prefill) --
    flash_cases = []
    h2o_flash = (BATCH, PROMPT, H, K, d, True, window)
    # jamba's attention layer: d = 128, G = 4, causal, no window
    hy_flash = (BATCH, HY_PROMPT, hy.num_heads, hy.num_kv_heads,
                hy.head_dim, True, None)
    # whisper's encoder: 1500 frames (11 full 128-row q-tiles and 92 rows),
    # non-causal, G = 1, d = 64; the VLM's self-attention: G = 8, d = 128
    wh_flash = (BATCH, wh.num_audio_frames, wh.num_heads, wh.num_kv_heads,
                wh.head_dim, False, None)
    vlm_flash = (BATCH, VLM_PROMPT, vlm.num_heads, vlm.num_kv_heads,
                 vlm.head_dim, True, None)
    # the distributed phase's train steps: h2o at 4 x 2048 (bf16; the
    # window spans the sequence) and its float32 check's 4 x 512
    train_flash = [(DIST[0], DIST[1], H, K, d, True, window),
                   (DIST_F32[1], DIST_F32[2], H, K, d, True, window)]
    for dt in (torch.float32, torch.bfloat16):
        extra = FLASH_BF16_DIMS if dt == torch.bfloat16 else []
        for case in FLASH_SWEEP + extra + train_flash + [
                wh_flash, vlm_flash, hy_flash, h2o_flash]:
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
    f_times = _flash_times(torch, gen, h2o_flash)
    f_hy = _flash_times(torch, gen, hy_flash)
    f_wh = _flash_times(torch, gen, wh_flash)
    f_vlm = _flash_times(torch, gen, vlm_flash)

    # -- decode attention --
    decode_cases = []
    # the last decode step's cache: h2o's ring of `window` slots has
    # wrapped, jamba's cache of prompt + gen slots has not
    ring = _ring_valid(torch, BATCH, window, PROMPT + GEN - 1)
    h2o_decode = (BATCH, window, H, K, d)
    hy_W = HY_PROMPT + GEN
    hy_valid = _ring_valid(torch, BATCH, hy_W, HY_PROMPT + GEN - 2)
    hy_decode = (BATCH, hy_W, hy.num_heads, hy.num_kv_heads, hy.head_dim)
    # whisper's last decode step: 256 slots, G = 1, d = 64; the VLM's: a
    # 4,128-slot cache, G = 8, d = 128 (neither wraps)
    wh_W, vlm_W = WH_PROMPT + GEN, VLM_PROMPT + GEN
    wh_valid = _ring_valid(torch, BATCH, wh_W, wh_W - 2)
    vlm_valid = _ring_valid(torch, BATCH, vlm_W, vlm_W - 2)
    wh_decode = (BATCH, wh_W, wh.num_heads, wh.num_kv_heads, wh.head_dim)
    vlm_decode = (BATCH, vlm_W, vlm.num_heads, vlm.num_kv_heads,
                  vlm.head_dim)
    valids = {h2o_decode: ring, hy_decode: hy_valid, wh_decode: wh_valid,
              vlm_decode: vlm_valid}
    # (q, cache) dtypes: float32, bf16, and a bf16 cache under float32 q
    for qt, ct in ((torch.float32, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.bfloat16)):
        for case in DECODE_SWEEP + [wh_decode, vlm_decode, hy_decode,
                                    h2o_decode]:
            B, W, Hc, Kc, dc = case
            q = _randn(torch, gen, (B, 1, Hc, dc), qt)
            k = _randn(torch, gen, (B, W, Kc, dc), ct)
            v = _randn(torch, gen, (B, W, Kc, dc), ct)
            valid = valids.get(case)
            if valid is None:
                valid = torch.rand((B, W), generator=gen,
                                   device=DEVICE) < 0.8
            bias = _bias(torch, valid)
            o = dops.decode_attention(q, k, v, bias)
            torch.cuda.synchronize()
            gold = decode_attention_ref(q.float(), k.float(), v.float(),
                                        bias)
            decode_cases.append(_held(
                torch, o, gold, case, qt if qt == ct else f"{qt}/{ct}"))
    d_times = _decode_times(torch, gen, h2o_decode, ring)
    d_hy = _decode_times(torch, gen, hy_decode, hy_valid)
    d_wh = _decode_times(torch, gen, wh_decode, wh_valid)
    d_vlm = _decode_times(torch, gen, vlm_decode, vlm_valid)
    # the float32-q route at G = 8 (the VLM's float32 gate takes it), with
    # a float32 and with a bf16 cache
    d_vlm_f32 = {}
    for qt, ct in ((torch.float32, torch.float32),
                   (torch.float32, torch.bfloat16)):
        label = str(qt) if qt == ct else f"{qt}/{ct}"   # as decode_cases'
        d_vlm_f32[label] = _decode_times(torch, gen, vlm_decode, vlm_valid,
                                         qt, ct)

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
    for name, t in (("flash_attention", f_times), ("flash_attention", f_hy),
                    ("flash_attention", f_wh), ("flash_attention", f_vlm),
                    ("decode_attention", d_times),
                    ("decode_attention", d_hy), ("decode_attention", d_wh),
                    ("decode_attention", d_vlm),
                    *(("decode_attention", t) for t in d_vlm_f32.values())):
        print(f"  {name} at {t['shape']} {t['dtype']}: {t['ms']:.4f} ms "
              f"(plain "
              f"{t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']}); device only "
              f"{_fmt(t['device_ms'])} ms, SDPA "
              f"{_fmt(t['library_device_ms'])} ms")
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
         **f_times, "at_" + HYBRID: dict(f_hy, max_abs_err=_case_err(
             flash_cases, hy_flash, torch.bfloat16)),
         "at_" + WHISPER + " encoder": dict(f_wh, max_abs_err=_case_err(
             flash_cases, wh_flash, torch.bfloat16)),
         "at_" + VLM: dict(f_vlm, max_abs_err=_case_err(
             flash_cases, vlm_flash, torch.bfloat16)),
         "cases": flash_cases},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/"
                   "decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/"
                     "decode_attention.py:55",
         "launches": None, "max_abs_err": decode_cases[-1]["max_abs_err"],
         **d_times, "at_" + HYBRID: dict(d_hy, max_abs_err=_case_err(
             decode_cases, hy_decode, torch.bfloat16)),
         "at_" + WHISPER: dict(d_wh, max_abs_err=_case_err(
             decode_cases, wh_decode, torch.bfloat16)),
         "at_" + VLM: dict(d_vlm, max_abs_err=_case_err(
             decode_cases, vlm_decode, torch.bfloat16)),
         **{f"at_{VLM} {label}": dict(t, max_abs_err=_case_err(
             decode_cases, vlm_decode, label))
            for label, t in d_vlm_f32.items()},
         "cases": decode_cases},
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


def _hybrid(**replace):
    return _config(HYBRID, num_layers=HY_LAYERS, **replace)


def phase_serve(torch, seed: int, card: str) -> dict:
    from repro_torch.models import model as M

    cfg = _h2o()
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    prompts = torch.randint(
        0, cfg.vocab_size, (BATCH, PROMPT), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 1))
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * (GEN - 1)}
    tokens, stats, logits, launches, peak_gb, _ = _serve_counted(
        torch, cfg, params, prompts, None, want)

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
    _f32_gate(kern32, gold, ARCH)
    gap = (logits - plain).abs().amax(dim=(0, 2))
    print(f"  bf16 kernel path vs plain path: max |dlogit| "
          f"{gap.max().item():.4f} (prefill {gap[0].item():.4f})")
    _excess_gate(logits, plain, gold, ARCH)
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


def _profile_decode(torch, cfg, params, prompts, tokens, steady_s,
                    extra=None) -> dict:
    """Trace PROFILE_STEPS kernel-path decode steps (after two untraced
    ones) with torch.profiler: device busy time and device events per step,
    the kernels that take most of it, and the device's idle share against
    the untraced steady decode step `steady_s`. `extra`: the prefill's
    cross-attention input."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill, make_serve_step
    (B, P), G = prompts.shape, tokens.shape[1]
    caches = M.init_caches(cfg, B, P + G, device=DEVICE)
    prefill = make_prefill(cfg)
    step = make_serve_step(cfg)
    with torch.no_grad():
        _, caches = prefill(params, caches, {"tokens": prompts,
                                             "extra": extra or {}})
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


@contextlib.contextmanager
def _recorded_routes():
    """Record each `_moe_route` call's (expert ids, kept), both (N, K) on
    the card, in call order, by wrapping the module function that the MoE
    layer calls; nothing in the model changes."""
    from repro_torch.models import layers as L
    calls, real = [], L._moe_route

    def recording(p, xt, moe_cfg):
        out = real(p, xt, moe_cfg)
        calls.append((out[1], out[0] > 0))
        return out
    L._moe_route = recording
    try:
        yield calls
    finally:
        L._moe_route = real


def _route_diffs(torch, cfg, a, b, shape) -> dict:
    """Two teacher-forced runs' recorded routes, prefill then one pass per
    decode step, compared choice by choice. `shape` is (B, P, G). Returns
    the differing (token, layer, k) choices by MoE layer, their total, the
    MoE layers upstream of the first attention layer, and `agree` (B, G):
    the positions whose own choices agree in every MoE layer. A token's MoE
    output depends only on its own choices and gates, and the one attention
    layer is the period's last, so no later mixer carries another
    position's flip to an agreeing one."""
    from repro_torch.models import model as M
    B, P, G = shape
    specs = M.block_specs(cfg)
    n_per = cfg.num_layers // len(specs)
    moe_at = [li * len(specs) + i for li in range(n_per)
              for i, sp in enumerate(specs) if sp["ffn"] == "moe"]
    first_attn = min(i for i, sp in enumerate(specs) if sp["kind"] == "attn")
    if not len(a) == len(b) == len(moe_at) * G:
        _fail(f"{cfg.name}: {len(a)} and {len(b)} routing calls, expected "
              f"{len(moe_at) * G}")
    by_layer = [0] * len(moe_at)
    total = 0
    agree = torch.ones((B, G), dtype=torch.bool, device=DEVICE)
    for c, ((ia, ka), (ib, kb)) in enumerate(zip(a, b)):
        t, j = divmod(c, len(moe_at))
        diff = (ia != ib) | (ka != kb)                       # (N, K)
        by_layer[j] += int(diff.sum())
        total += diff.numel()
        mine = diff.any(-1)
        agree[:, t] &= ~(mine.reshape(B, P)[:, -1] if t == 0 else mine)
    return {"differing_by_layer": dict(zip(moe_at, by_layer)),
            "differing": sum(by_layer), "choices": total,
            "upstream_layers": [x for x in moe_at if x < first_attn],
            "agree": agree}


@contextlib.contextmanager
def _timed(torch, targets):
    """Wrap each function `name` of `module`, for (module, name) in
    `targets`, with CUDA events around each call, for the `with` block
    only; yields {name: [(start, end), ...]} (read after a synchronize).
    Callers find the wrapper by the module's global, so a kernel wrapper's
    own launch count is untouched."""
    real = {(m, n): getattr(m, n) for m, n in targets}
    spans = {n: [] for _, n in targets}

    def timed(module, name):
        def call(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = real[module, name](*a, **k)
            e.record()
            spans[name].append((s, e))
            return out
        return call
    for m, n in targets:
        setattr(m, n, timed(m, n))
    try:
        yield spans
    finally:
        for (m, n), fn in real.items():
            setattr(m, n, fn)


def _span_ms(spans) -> dict:
    return {n: sum(a.elapsed_time(b) for a, b in v) for n, v in spans.items()}


def _prefill_split(torch, cfg, params, prompts, names, extra=None,
                   model_names=()) -> dict:
    """CUDA-event time of each function `names` of `models.layers` (and
    `model_names` of `models.model`) over one kernel-path prefill (the
    functions wrapped for this run only; nested ones are inside their
    callers' time). `extra`: the cross-attention input."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill
    caches = M.init_caches(cfg, prompts.shape[0], prompts.shape[1] + GEN,
                           device=DEVICE)
    prefill = make_prefill(cfg)
    targets = [(L, n) for n in names] + [(M, n) for n in model_names]
    with _timed(torch, targets) as spans, torch.no_grad():
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        prefill(params, caches, {"tokens": prompts, "extra": extra or {}})
        e.record()
        torch.cuda.synchronize()
    out = _span_ms(spans)
    out["calls"] = {n: len(v) for n, v in spans.items()}
    out["prefill"] = s.elapsed_time(e)
    return out


def _profile_prefill(torch, cfg, params, prompts, extra=None) -> dict:
    """One kernel-path prefill under torch.profiler: device busy ms and the
    TOP_OPS device ops by their summed time. `extra`: the cross-attention
    input."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill
    caches = M.init_caches(cfg, prompts.shape[0], prompts.shape[1] + GEN,
                           device=DEVICE)
    prefill = make_prefill(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill(params, caches, {"tokens": prompts,
                                     "extra": extra or {}})
            torch.cuda.synchronize()
    spans, by_name = _device_spans(torch, prof), {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0)
                                + ev.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return {"device_busy_ms": _busy_us(spans) / 1e3 if spans else None,
            "device_events": len(spans),
            "top_device_ms": {n: us / 1e3 for n, us in top}}


def _hybrid_f32_gate(torch, seed: int) -> dict:
    """jamba at full width (one period) in float32: the kernel path and the
    plain path teacher-forced over the same random prompt and tokens, with
    float32 caches; logits within LOGIT_TOL_F32 at every position and the
    same expert choices in every MoE layer."""
    from repro_torch.models import model as M
    B, P, steps = HY_F32
    cfg = _hybrid(param_dtype="float32", compute_dtype="float32")
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    g = torch.Generator(DEVICE).manual_seed(seed + 2)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), device=DEVICE,
                            generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (B, steps + 1), device=DEVICE,
                           generator=g)
    runs = {}
    for use_kernels in (True, False):
        with _recorded_routes() as routes:
            logits, _ = _teacher_forced(cfg, params, prompts, tokens,
                                        use_kernels, torch.float32)
        runs[use_kernels] = (logits, routes)
    del params
    torch.cuda.empty_cache()
    d = _route_diffs(torch, cfg, runs[True][1], runs[False][1],
                     (B, P, steps + 1))
    err = (runs[True][0] - runs[False][0]).abs().max().item()
    print(f"  float32 (batch {B}, prompt {P}, {steps} decode steps), kernel "
          f"path vs plain path: max |dlogit| {err:.3e} (tol "
          f"{LOGIT_TOL_F32}); differing expert choices {d['differing']} of "
          f"{d['choices']} (tol 0)")
    if not err <= LOGIT_TOL_F32:
        _fail(f"{HYBRID} float32: logits differ by {err} > {LOGIT_TOL_F32}")
    if d["differing"]:
        _fail(f"{HYBRID} float32: {d['differing']} expert choices differ "
              f"between the paths")
    return {"batch": B, "prompt": P, "decode_steps": steps,
            "max_abs_logit_err": err, "differing_choices": d["differing"],
            "choices": d["choices"]}


def phase_serve_hybrid(torch, seed: int, card: str) -> tuple:
    """jamba-v0.1-52b, one period at full width: serve through the
    kernels, the bf16 and float32 gates, and where the time goes."""
    from repro_torch.models import model as M

    cfg = _hybrid()
    specs = M.block_specs(cfg)
    n_attn = (sum(sp["kind"] == "attn" for sp in specs)
              * (cfg.num_layers // len(specs)))
    torch.cuda.empty_cache()
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    n_params, weights_gb = _weights(params)
    prompts = torch.randint(
        0, cfg.vocab_size, (BATCH, HY_PROMPT), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 1))
    want = {"flash_attention": n_attn,
            "decode_attention": n_attn * (GEN - 1)}
    with _recorded_routes() as kernel_routes:
        tokens, stats, logits, launches, peak_gb, _ = _serve_counted(
            torch, cfg, params, prompts, None, want)
    print(f"  serve {HYBRID} ({cfg.num_layers} of 32 layers, bf16, "
          f"{n_params / 1e9:.3f} B params, {weights_gb:.2f} GB of weights) "
          f"batch {BATCH} prompt {HY_PROMPT} gen {GEN} on {card}: prefill "
          f"{stats['prefill_tokens_per_s']:.1f} tok/s "
          f"({stats['prefill_s']:.4f} s), decode "
          f"{stats['decode_tokens_per_s']:.1f} tok/s "
          f"({stats['decode_s']:.4f} s; first step "
          f"{stats['decode_first_step_s'] * 1e3:.2f} ms, steady "
          f"{stats['decode_steady_step_s'] * 1e3:.2f} ms/step = "
          f"{stats['decode_steady_tokens_per_s']:.1f} tok/s); peak memory "
          f"{peak_gb:.2f} GB")
    print(f"  greedy tokens (not gated): {tokens.tolist()}")

    # bf16: the plain path teacher-forced with the kernel path's tokens
    with _recorded_routes() as plain_routes:
        plain, plain_s = _teacher_forced(cfg, params, prompts, tokens, False,
                                         torch.bfloat16)
    d = _route_diffs(torch, cfg, kernel_routes, plain_routes,
                     (BATCH, HY_PROMPT, GEN))
    del kernel_routes, plain_routes
    gap = (logits - plain).abs().amax(-1)                      # (B, G)
    agree = d.pop("agree")
    n_agree = int(agree.sum())
    gap_agree = gap[agree].max().item() if n_agree else float("nan")
    share = d["differing"] / d["choices"]
    upstream = sum(d["differing_by_layer"][x] for x in d["upstream_layers"])
    print(f"  bf16, kernel path vs plain path (teacher-forced): "
          f"{d['differing']} of {d['choices']} expert choices differ "
          f"(share {share:.3e}, tol {HY_FLIP_SHARE}; by layer "
          f"{d['differing_by_layer']}; upstream of the attention layer "
          f"{upstream}, tol 0); positions whose choices all agree "
          f"{n_agree} of {agree.numel()}: largest logit gap there "
          f"{gap_agree:.4f} (tol {HY_AGREE_TOL}), over all positions "
          f"{gap.max().item():.4f}; plain path prefill "
          f"{BATCH * HY_PROMPT / plain_s[0]:.1f} tok/s, decode "
          f"{BATCH * (GEN - 1) / plain_s[1]:.1f} tok/s")
    if upstream:
        _fail(f"{HYBRID} bf16: {upstream} expert choices differ upstream of "
              f"the attention layer, where the paths run the same code")
    if not share <= HY_FLIP_SHARE:
        _fail(f"{HYBRID} bf16: {share} of the expert choices differ "
              f"between the paths (tol {HY_FLIP_SHARE})")
    if not (2 * n_agree >= agree.numel() and gap_agree <= HY_AGREE_TOL):
        _fail(f"{HYBRID} bf16: logit gap {gap_agree} at the {n_agree} "
              f"agreeing positions (tol {HY_AGREE_TOL}, at least half of "
              f"{agree.numel()} positions)")
    del plain

    split = _prefill_split(torch, cfg, params, prompts, (
        "moe_ffn", "_expert_ffn", "mamba", "_mamba_ssm_chunked",
        "self_attention", "swiglu"))
    moe, ex = split["moe_ffn"], split["_expert_ffn"]
    mam, scan = split["mamba"], split["_mamba_ssm_chunked"]
    att = split["self_attention"]
    rest = split["prefill"] - moe - mam - att - split["swiglu"]
    print(f"  prefill split (CUDA events, one prefill, {split['prefill']:.1f}"
          f" ms): MoE FFN {moe:.1f} ms (expert FFNs {ex:.1f}, routing and "
          f"one-hot dispatch / combine {moe - ex:.1f}); Mamba {mam:.1f} ms "
          f"(scan {scan:.1f}, projections and conv {mam - scan:.1f}); "
          f"attention {att:.1f} ms (its flash kernel: phase 3); dense FFN "
          f"{split['swiglu']:.1f} ms; the rest (embed, norms, unembed) "
          f"{rest:.1f} ms; calls {split['calls']}")
    top = _profile_prefill(torch, cfg, params, prompts)
    print(f"  prefill profile (torch.profiler): device busy "
          f"{_fmt(top['device_busy_ms'])} ms over {top['device_events']} "
          f"device events; the top {TOP_OPS} device ops:")
    for n, ms in top["top_device_ms"].items():
        print(f"    {ms:9.3f} ms  {n[:100]}")
    prof = _profile_decode(torch, cfg, params, prompts, tokens,
                           stats["decode_steady_step_s"])
    del params, logits
    torch.cuda.empty_cache()

    f32 = _hybrid_f32_gate(torch, seed)
    return launches, dict(
        stats, layers=cfg.num_layers, params=n_params, weights_gb=weights_gb,
        peak_memory_gb=peak_gb, tokens=tokens.tolist(),
        bf16_gate={"differing_choices": d["differing"],
                   "choices": d["choices"], "share": share,
                   "differing_by_layer": d["differing_by_layer"],
                   "agreeing_positions": n_agree,
                   "positions": agree.numel(),
                   "max_logit_gap_agreeing": gap_agree,
                   "max_logit_gap": gap.max().item()},
        plain_path={"prefill_s": plain_s[0], "decode_s": plain_s[1]},
        prefill_split_ms=split, prefill_profile=top, profile=prof,
        float32_gate=f32)


def _serve_counted(torch, cfg, params, prompts, extra, want, targets=()):
    """`serve` through the kernels, each kernel's count set to 0 just
    before the run and read just after: the counts must equal `want`;
    tokens, logits and their shapes are checked. `targets` are timed
    during the run (see `_timed`). Returns (tokens, stats, logits,
    launches, peak memory GB, the targets' ms)."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch.serve import serve
    B, P = prompts.shape
    torch.cuda.reset_peak_memory_stats()
    fops.flash_attention.launches = 0
    dops.decode_attention.launches = 0
    with _timed(torch, targets) as spans:
        tokens, stats, logits = serve(cfg, batch=B, prompt_len=P, gen=GEN,
                                      use_kernels=True, device=DEVICE,
                                      params=params, prompts=prompts,
                                      extra=extra)
    launches = {"flash_attention": fops.flash_attention.launches,
                "decode_attention": dops.decode_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    print(f"  launches {launches} (expected {want})")
    if launches != want:
        _fail(f"serve {cfg.name} launched {launches}, expected {want}")
    if tuple(tokens.shape) != (B, GEN) or tuple(logits.shape) != (
            B, GEN, cfg.padded_vocab()):
        _fail(f"{cfg.name} shapes: tokens {tuple(tokens.shape)}, logits "
              f"{tuple(logits.shape)}")
    if not (0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size):
        _fail(f"{cfg.name}: generated token ids out of the vocabulary")
    if not bool(torch.isfinite(logits).all()):
        _fail(f"{cfg.name}: non-finite logits on the kernel path")
    return tokens, stats, logits, launches, peak_gb, _span_ms(spans)


def _excess_gate(kern, plain, gold, name) -> dict:
    """Phase 4's bf16 gate and limits: each bf16 path's logits (B, G, Vp)
    against the float32 plain path's `gold`; at no position may the kernel
    path's largest error exceed the plain path's by more than
    BF16_EXCESS_TOL, and its RMS error over all logits may be at most
    BF16_RMS_RATIO times the plain path's."""
    excess_tol, rms_tol = BF16_EXCESS_TOL, BF16_RMS_RATIO
    def err(a, b):         # max |a - b| at each position: (G,)
        return (a - b).abs().amax(dim=(0, 2))

    def rms(a, b):
        return (a - b).square().mean().sqrt().item()
    e_kernel, e_plain = err(kern, gold), err(plain, gold)
    excess = (e_kernel - e_plain).max().item()
    ratio = rms(kern, gold) / rms(plain, gold)
    print(f"  bf16 vs the float32 plain path: max |dlogit| kernel path "
          f"{e_kernel.max().item():.4f}, plain path "
          f"{e_plain.max().item():.4f}; RMS kernel path "
          f"{rms(kern, gold):.5f}, plain path {rms(plain, gold):.5f}; "
          f"kernel-path excess largest per position {excess:.4f} (tol "
          f"{excess_tol}), RMS ratio {ratio:.4f} (tol {rms_tol})")
    if not excess <= excess_tol:
        _fail(f"{name} bf16: the kernel path is {excess} farther from "
              f"float32 than the plain path at some position (tol "
              f"{excess_tol})")
    if not ratio <= rms_tol:
        _fail(f"{name} bf16: the kernel path's RMS logit error is {ratio} "
              f"times the plain path's (tol {rms_tol})")
    return {"max_err_kernel": e_kernel.max().item(),
            "max_err_plain": e_plain.max().item(), "excess": excess,
            "rms_ratio": ratio, "excess_tol": excess_tol,
            "rms_ratio_tol": rms_tol}


def _f32_gate(kern32, plain32, name) -> float:
    """The float32 logits (B, G, Vp) of the two paths within LOGIT_TOL_F32
    at every position (the first is the prefill's last)."""
    by_pos = (kern32 - plain32).abs().amax(dim=(0, 2))
    err = by_pos.max().item()
    print(f"  float32, kernel path vs plain path: max |dlogit| {err:.3e} "
          f"(tol {LOGIT_TOL_F32}); by position "
          f"{' '.join(f'{e:.1e}' for e in by_pos.tolist())}")
    if not err <= LOGIT_TOL_F32:
        _fail(f"{name} float32: the kernel path's logits differ from the "
              f"plain path's by {err} > {LOGIT_TOL_F32}")
    return err


def _live(a, b, what, name) -> float:
    """The float32 logits must move by at least LIVE_MIN when the cross
    path's input is taken away: else the gates above held a dead path."""
    moved = (a - b).abs().max().item()
    print(f"  liveness: {what} moves the float32 logits by {moved:.4e} "
          f"(at least {LIVE_MIN})")
    if not moved >= LIVE_MIN:
        _fail(f"{name}: {what} moves the logits by only {moved}")
    return moved


def _weights(params) -> tuple:
    """(parameter count, GB) of a params tree."""
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    return (sum(p.numel() for p in leaves),
            sum(p.nbytes for p in leaves) / 1e9)


def _set_gates(params, cfg, value) -> None:
    """Every cross-attention gate (the VLM's xattn layers) to `value`."""
    from repro_torch.models import model as M
    for i, spec in enumerate(M.block_specs(cfg)):
        if spec["kind"] == "xattn":
            params["layers"][i]["attn"]["gate"].fill_(value)


def _serve_whisper(torch, seed: int, card: str) -> tuple:
    """whisper-large-v3 whole, bf16: serve through the kernels with random
    frames (the encoder's time by CUDA events), the float32 and bf16 gates
    and liveness, and where the time goes."""
    from repro_torch.models import model as M
    cfg = _config(WHISPER)
    torch.cuda.empty_cache()
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    n_params, weights_gb = _weights(params)
    prompts = torch.randint(
        0, cfg.vocab_size, (BATCH, WH_PROMPT), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 1))
    frames = torch.randn(
        (BATCH, cfg.num_audio_frames, cfg.d_model), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 3)).to(
        torch.bfloat16)
    extra = {"audio_frames": frames}
    want = {"flash_attention": cfg.encoder_layers + cfg.num_layers,
            "decode_attention": cfg.num_layers * (GEN - 1)}
    tokens, stats, logits, launches, peak_gb, timed = _serve_counted(
        torch, cfg, params, prompts, extra, want,
        targets=[(M, "_run_encoder")])
    enc_ms = timed["_run_encoder"]
    print(f"  serve {WHISPER} ({cfg.encoder_layers} encoder + "
          f"{cfg.num_layers} decoder layers, bf16, {n_params / 1e9:.3f} B "
          f"params, {weights_gb:.2f} GB of weights) batch {BATCH}, "
          f"{cfg.num_audio_frames} frames, prompt {WH_PROMPT}, gen {GEN} on "
          f"{card}: prefill {stats['prefill_tokens_per_s']:.1f} tok/s "
          f"({stats['prefill_s']:.4f} s, of it the encoder {enc_ms:.2f} ms "
          f"by CUDA events), decode {stats['decode_tokens_per_s']:.1f} tok/s "
          f"({stats['decode_s']:.4f} s; first step "
          f"{stats['decode_first_step_s'] * 1e3:.2f} ms, steady "
          f"{stats['decode_steady_step_s'] * 1e3:.2f} ms/step = "
          f"{stats['decode_steady_tokens_per_s']:.1f} tok/s); peak memory "
          f"{peak_gb:.2f} GB")

    # the kernel path against the plain path, teacher-forced with the
    # kernel path's tokens, and a float32 run of the same weights and
    # frames as the yardstick; then the frames zeroed
    plain, plain_s = _teacher_forced(cfg, params, prompts, tokens, False,
                                     torch.bfloat16, extra)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = _cast(params, torch.float32)
    extra32 = {"audio_frames": frames.float()}
    gold, _ = _teacher_forced(cfg32, params32, prompts, tokens, False,
                              torch.float32, extra32)
    kern32, _ = _teacher_forced(cfg32, params32, prompts, tokens, True,
                                torch.float32, extra32)
    zeroed, _ = _teacher_forced(
        cfg32, params32, prompts, tokens, True, torch.float32,
        {"audio_frames": torch.zeros_like(extra32["audio_frames"])})
    del params32
    torch.cuda.empty_cache()
    f32_err = _f32_gate(kern32, gold, WHISPER)
    bf16 = _excess_gate(logits, plain, gold, WHISPER)
    live = _live(kern32, zeroed, "zeroing the audio frames", WHISPER)
    del plain, gold, kern32, zeroed
    print(f"  plain path: prefill {BATCH * WH_PROMPT / plain_s[0]:.1f} "
          f"tok/s, decode {BATCH * (GEN - 1) / plain_s[1]:.1f} tok/s")

    split = _prefill_split(torch, cfg, params, prompts,
                           ("self_attention", "cross_attention", "swiglu"),
                           extra, ("_run_encoder",))
    top = _profile_prefill(torch, cfg, params, prompts, extra)
    _print_split(split, top)
    prof = _profile_decode(torch, cfg, params, prompts, tokens,
                           stats["decode_steady_step_s"], extra)
    del params, logits
    torch.cuda.empty_cache()
    return launches, dict(
        stats, encoder_ms=enc_ms, params=n_params, weights_gb=weights_gb,
        peak_memory_gb=peak_gb, tokens=tokens.tolist(),
        float32_gate={"max_abs_logit_err": f32_err}, bf16_gate=bf16,
        liveness={"zeroed_frames_max_abs_logit_move": live},
        plain_path={"prefill_s": plain_s[0], "decode_s": plain_s[1]},
        prefill_split_ms=split, prefill_profile=top, profile=prof)


def _print_split(split, top) -> None:
    rest = split["prefill"] - sum(v for k, v in split.items()
                                  if k not in ("calls", "prefill",
                                               "_run_encoder"))
    print(f"  prefill split (CUDA events, one prefill, "
          f"{split['prefill']:.1f} ms): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()
                      if k not in ("calls", "prefill"))
          + f"; outside the layer functions {rest:.1f} ms; calls "
          f"{split['calls']}")
    print(f"  prefill profile (torch.profiler): device busy "
          f"{_fmt(top['device_busy_ms'])} ms over {top['device_events']} "
          f"device events; the top {TOP_OPS} device ops:")
    for n, ms in top["top_device_ms"].items():
        print(f"    {ms:9.3f} ms  {n[:100]}")


def _serve_vlm(torch, seed: int, card: str) -> tuple:
    """llama-3.2-vision-90b at full width, one period, bf16: serve through
    the kernels with random image embeddings and the gate at XA_GATE;
    where the time goes; then the gates at VLM_GATES: bf16 (kernel and
    plain paths against float32), float32 (kernel vs plain path, after the
    bf16 weights are freed) and liveness (gate 0 against XA_GATE)."""
    from repro_torch.models import model as M
    cfg = _config(VLM, num_layers=VLM_LAYERS)
    specs = M.block_specs(cfg)
    n_attn = (sum(sp["kind"] == "attn" for sp in specs)
              * (cfg.num_layers // len(specs)))
    torch.cuda.empty_cache()
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    _set_gates(params, cfg, XA_GATE)
    n_params, weights_gb = _weights(params)
    prompts = torch.randint(
        0, cfg.vocab_size, (BATCH, VLM_PROMPT), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 1))
    embeds = torch.randn(
        (BATCH, cfg.num_image_tokens, cfg.d_model), device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed + 3)).to(
        torch.bfloat16)
    extra = {"image_embeds": embeds}
    want = {"flash_attention": n_attn, "decode_attention": n_attn * (GEN - 1)}
    tokens, stats, logits, launches, peak_gb, _ = _serve_counted(
        torch, cfg, params, prompts, extra, want)
    print(f"  serve {VLM} ({cfg.num_layers} of 100 layers, bf16, "
          f"{n_params / 1e9:.3f} B params, {weights_gb:.2f} GB of weights, "
          f"gate {XA_GATE}) batch {BATCH}, {cfg.num_image_tokens} image "
          f"tokens, prompt {VLM_PROMPT}, gen {GEN} on {card}: prefill "
          f"{stats['prefill_tokens_per_s']:.1f} tok/s "
          f"({stats['prefill_s']:.4f} s), decode "
          f"{stats['decode_tokens_per_s']:.1f} tok/s "
          f"({stats['decode_s']:.4f} s; first step "
          f"{stats['decode_first_step_s'] * 1e3:.2f} ms, steady "
          f"{stats['decode_steady_step_s'] * 1e3:.2f} ms/step = "
          f"{stats['decode_steady_tokens_per_s']:.1f} tok/s); peak memory "
          f"{peak_gb:.2f} GB")
    del logits
    split = _prefill_split(torch, cfg, params, prompts,
                           ("self_attention", "cross_attention", "swiglu"),
                           extra)
    top = _profile_prefill(torch, cfg, params, prompts, extra)
    _print_split(split, top)
    prof = _profile_decode(torch, cfg, params, prompts, tokens,
                           stats["decode_steady_step_s"], extra)
    del extra, embeds

    B, P, steps = VLM_GATES
    g = torch.Generator(DEVICE).manual_seed(seed + 2)
    g_prompts = torch.randint(0, cfg.vocab_size, (B, P), device=DEVICE,
                              generator=g)
    g_tokens = torch.randint(0, cfg.vocab_size, (B, steps + 1),
                             device=DEVICE, generator=g)
    g_embeds = torch.randn((B, cfg.num_image_tokens, cfg.d_model),
                           device=DEVICE, generator=g).to(torch.bfloat16)
    kern16, _ = _teacher_forced(cfg, params, g_prompts, g_tokens, True,
                                torch.bfloat16, {"image_embeds": g_embeds})
    plain16, _ = _teacher_forced(cfg, params, g_prompts, g_tokens, False,
                                 torch.bfloat16, {"image_embeds": g_embeds})
    params32 = _cast(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    extra32 = {"image_embeds": g_embeds.float()}
    runs = {}
    for use_kernels in (False, True):
        runs[use_kernels], _ = _teacher_forced(
            cfg32, params32, g_prompts, g_tokens, use_kernels, torch.float32,
            extra32)
    _set_gates(params32, cfg32, 0.0)
    shut, _ = _teacher_forced(cfg32, params32, g_prompts, g_tokens, True,
                              torch.float32, extra32)
    del params32
    torch.cuda.empty_cache()
    print(f"  gates at batch {B}, prompt {P}, {steps} decode steps:")
    f32_err = _f32_gate(runs[True], runs[False], VLM)
    bf16 = _excess_gate(kern16, plain16, runs[False], VLM)
    live = _live(runs[True], shut, f"the gate at 0 instead of {XA_GATE}",
                 VLM)
    return launches, dict(
        stats, layers=cfg.num_layers, params=n_params, weights_gb=weights_gb,
        peak_memory_gb=peak_gb, tokens=tokens.tolist(), gate=XA_GATE,
        gates_at={"batch": B, "prompt": P, "decode_steps": steps},
        float32_gate={"max_abs_logit_err": f32_err}, bf16_gate=bf16,
        liveness={"gate0_max_abs_logit_move": live},
        prefill_split_ms=split, prefill_profile=top, profile=prof)


def phase_serve_xattn(torch, seed: int, card: str) -> tuple:
    """The cross-attention families: whisper-large-v3 whole, then
    llama-3.2-vision-90b's one period. Returns (launches by model,
    results by model)."""
    print(f"  -- {WHISPER}")
    wh_launches, wh = _serve_whisper(torch, seed, card)
    print(f"  -- {VLM} ({VLM_LAYERS} layers)")
    vlm_launches, vlm = _serve_vlm(torch, seed, card)
    return ({WHISPER: wh_launches, VLM: vlm_launches},
            {WHISPER: wh, VLM: vlm})


def phase_checkpoint(torch, seed: int, card: str) -> dict:
    """(a) Resume equivalence through train_loop on the card; (b) a
    full-width round trip of h2o-danube-1.8b's bf16 params, bit for
    bit."""
    import shutil
    from repro_torch.core.streaming_checkpoint import StreamingCheckpointer
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    try:
        arch, B, S, steps, every = CKPT_RESUME
        cfg = _config(arch, param_dtype="float32", compute_dtype="float32")
        kw = dict(steps=steps, batch=B, seq=S, seed=seed, log_every=steps,
                  device=DEVICE, use_kernels=True, ckpt_dir=root / "resume",
                  ckpt_every=every)
        _, straight = train_loop(cfg, **kw)
        ck = StreamingCheckpointer(root / "resume")
        if ck.all_steps() != [every, steps]:
            _fail(f"checkpoints at steps {ck.all_steps()}, expected "
                  f"{[every, steps]}")
        # as if the run had died after step `every`'s checkpoint
        shutil.rmtree(root / "resume" / f"step_{steps:08d}")
        state, resumed = train_loop(cfg, resume=True, **kw)
        want = straight["losses"][every:]
        rel = max((_rel(a, b) for a, b in zip(resumed["losses"], want)),
                  default=float("inf"))
        print(f"  {arch} float32 {B}x{S}, kernel path: {steps} steps with a "
              f"checkpoint every {every}, losses {straight['losses']}; "
              f"resumed from step {every}: {resumed['losses']} "
              f"({rel:.3e} relative, tol {RESUME_RTOL})")
        if not (state.step == steps and len(resumed["losses"]) == len(want)
                and rel <= RESUME_RTOL):
            _fail(f"{arch}: the resumed run's losses {resumed['losses']} "
                  f"are not the straight run's {want}")
        out[arch] = {"losses": straight["losses"],
                     "resumed_losses": resumed["losses"], "rel_err": rel}
        del state

        cfg = _h2o()
        params = M.init_params(torch.Generator(DEVICE).manual_seed(seed),
                               cfg)
        ck = StreamingCheckpointer(root / "h2o")
        free_gb = shutil.disk_usage(root).free / 1e9
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(0, params)
        write_s = time.perf_counter() - t0
        m = ck.metrics
        t0 = time.perf_counter()
        back = ck.restore(params)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        same = all(torch.equal(a.reshape(-1).view(torch.uint8),
                               b.reshape(-1).view(torch.uint8))
                   and a.dtype == b.dtype and a.shape == b.shape
                   for a, b in zip(tree_leaves(params), tree_leaves(back)))
        bound = ck.buffers * ck.chunk_bytes
        gb = m.bytes_written / 1e9
        print(f"  {ARCH} bf16 params ({gb:.3f} GB, {m.n_leaves} leaves, "
              f"{m.n_chunks} chunks; {free_gb:.0f} GB free before): write "
              f"{write_s:.2f} s = {gb / write_s:.3f} GB/s, read "
              f"{read_s:.2f} s = {gb / read_s:.3f} GB/s, bit for bit "
              f"{same}; peak in flight {m.peak_buffer_bytes} B (bound "
              f"{ck.buffers} x {ck.chunk_bytes} = {bound} B)")
        if not same:
            _fail(f"{ARCH}: restored params differ from the saved ones")
        if not m.peak_buffer_bytes <= bound:
            _fail(f"checkpoint: {m.peak_buffer_bytes} B in flight > {bound}")
        out[ARCH] = {"gb": gb, "write_s": write_s, "read_s": read_s,
                     "write_gb_per_s": gb / write_s,
                     "read_gb_per_s": gb / read_s,
                     "peak_buffer_bytes": m.peak_buffer_bytes,
                     "bound_bytes": bound, "chunks": m.n_chunks}
    finally:
        shutil.rmtree(root, ignore_errors=True)
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


def _dist_run(torch, cfg, seed, batches, mesh=None, grad_sync="gspmd",
              keep=False, profile=False, oc=None, use_kernels=True,
              make_step=None) -> dict:
    """Train `cfg` from random weights made from `seed` on `batches`: on
    `mesh` (state placed by state_specs; replicated over pods for the
    compressed sync) or without one; `oc` the optimizer (default: the
    reference's test's, lr DIST_LR); `use_kernels` False takes the plain
    paths; `make_step(cfg, oc)`, where given, makes the step in place of
    make_train_step. Returns the losses, each step's
    seconds (host clock around a synchronised step), the steady mean (steps
    2 on), tokens/s, the memory held once the state is placed and the peak
    over the steps (GB), flash launches, with `profile` one more step under
    torch.profiler (device busy ms, events, idle share against the steady
    step, top device ops), and with `keep` the final state."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding.rules import ShardingRules, place, state_specs
    from repro_torch.train.steps import make_train_step
    compressed = grad_sync == "compressed_pod"
    oc = oc or OptimizerConfig(lr=DIST_LR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(DEVICE).manual_seed(seed), cfg)
    state = adamw_init(params, oc, with_ef=compressed)
    del params
    rules = None
    if mesh is not None:
        rules = ShardingRules(mesh)
        state = place(state, state_specs(state, mesh,
                                         fsdp_pod=not compressed), mesh)
    step = (make_step(cfg, oc) if make_step else
            make_train_step(cfg, oc, rules, grad_sync=grad_sync,
                            use_kernels=use_kernels))
    placed_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    fops.flash_attention.launches = 0
    losses, step_s = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    n = fops.flash_attention.launches
    steady = sum(step_s[1:]) / len(step_s[1:])
    B, S = batches[0]["tokens"].shape
    out = {"losses": losses, "step_s": step_s, "first_step_s": step_s[0],
           "steady_step_s": steady, "tokens_per_s": B * S / steady,
           "placed_memory_gb": placed_gb,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "flash_launches": n}
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, batches[-1])
            torch.cuda.synchronize()
        spans, by_name = _device_spans(torch, prof), {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0)
                                    + ev.time_range.elapsed_us())
        busy = _busy_us(spans) / 1e3 if spans else None
        out["profile"] = {
            "device_busy_ms": busy, "device_events": len(spans),
            "idle_share": None if busy is None
            else 1 - busy / (steady * 1e3),
            "top_device_ms": {k: us / 1e3 for k, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP_OPS]}}
    if keep:
        out["state"] = state
    return out


def _local(tree):
    """Each DTensor leaf's local tensor (the whole leaf at world 1)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    tree)


def _bf16_round(np, a):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    b = a.view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _quantized_psum_np(np, x, ef):
    """The reference's quantized psum (src/repro/core/collectives.py:43-53)
    over one pod, in numpy float32: (out, new_ef) of a bf16 leaf, both
    rounded to bf16 and returned as float32."""
    f32 = np.float32
    val = x + ef
    scale = np.maximum(f32(np.abs(val).max()) / f32(127.0), f32(1e-12))
    q = np.clip(np.round(val / scale), -127, 127).astype(f32)
    new_ef = _bf16_round(np, val - q * scale)
    summed = q.astype(np.int16).astype(f32)
    return _bf16_round(np, summed * scale / f32(1)), new_ef


def _compressed_replay(cfg, oc):
    """The compressed step's arithmetic with no mesh and no collective:
    the meshless gradients, each leaf quantized to int8 with error
    feedback by the reference's formula (src/repro/core/collectives.py:
    43-53; one pod, so the wire sum is the leaf's own codes and the mean
    divides by 1), the ef written, then AdamW. Divisors are device
    tensors, as IEEE division (numpy's) is."""
    import torch
    from repro_torch.optim import adamw_update, cosine_schedule
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.tree import tree_leaves, tree_unflatten
    grad_fn = make_grad_fn(cfg)
    lr_fn = cosine_schedule(oc.lr, oc.warmup, oc.total_steps)

    def step(state, batch):
        metrics, grads = grad_fn(state.params, batch)
        synced = []
        for g, e in zip(tree_leaves(grads), tree_leaves(state.ef)):
            val = g.float() + e.float()
            c127 = torch.full((), 127.0, device=val.device)
            scale = torch.clamp(val.abs().max() / c127, min=1e-12)
            q = torch.clamp(torch.round(val / scale), -127, 127)
            e.copy_((val - q * scale).to(e.dtype))
            synced.append((q * scale).to(g.dtype))
        del grads
        return adamw_update(state, tree_unflatten(state.params, synced), oc,
                            lr_fn), metrics
    return step


def phase_distributed(torch, seed: int, card: str) -> tuple:
    """The sharded train step, the compressed cross-pod sync, elastic
    recovery and the all-reduce schedules on a world-1 NCCL group; returns
    (flash launches by path, the distributed block of the result line)."""
    import shutil
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.collectives import (flat_all_reduce,
                                              hierarchical_all_reduce,
                                              quantized_psum_pod)
    from repro_torch.core.elastic import ElasticRunner
    from repro_torch.core.streaming_checkpoint import StreamingCheckpointer
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.sharding.rules import gather
    from repro_torch.train.steps import make_grad_fn, make_train_step
    from repro_torch.tree import tree_leaves
    root = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(root / "store"), 1), rank=0, world_size=1)
    launches, out = {}, {}
    try:
        mesh2 = make_host_mesh(1, 1)
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))

        # (a) float32, 2 layers: the (1, 1) mesh against no mesh
        layers, B, S, steps = DIST_F32
        cfg = _config(ARCH, num_layers=layers, param_dtype="float32",
                      compute_dtype="float32")
        batches = [_device_batch(torch, cfg, B, S, i, seed)
                   for i in range(steps)]
        f32 = {m: _dist_run(torch, cfg, seed, batches, mesh, keep=True)
               for m, mesh in (("mesh", mesh2), ("none", None))}
        rel = max(_rel(a, b) for a, b in zip(f32["mesh"]["losses"],
                                             f32["none"]["losses"]))
        got = tree_leaves(gather(f32["mesh"]["state"].params))
        want = tree_leaves(f32["none"]["state"].params)
        top = max(float(p.abs().max()) for p in want)
        perr = max(float((a - b).abs().max()) for a, b in zip(got, want)) \
            / top
        print(f"  {ARCH} {layers} layers float32 {B}x{S}, {steps} steps: "
              f"(1, 1) mesh losses {f32['mesh']['losses']}, no mesh "
              f"{f32['none']['losses']} ({rel:.3e} relative, tol "
              f"{LOSS_RTOL}); params {perr:.3e} of the largest |p| (tol "
              f"{DIST_PARAM_TOL}); flash launches "
              f"{f32['mesh']['flash_launches']} / "
              f"{f32['none']['flash_launches']}")
        if not (rel <= LOSS_RTOL and perr <= DIST_PARAM_TOL):
            _fail(f"{ARCH} float32 on a (1, 1) mesh: losses {rel} relative, "
                  f"params {perr} off the meshless run")
        if f32["mesh"]["flash_launches"] != f32["none"]["flash_launches"]:
            _fail("float32 mesh run: flash launched "
                  f"{f32['mesh']['flash_launches']} times, meshless "
                  f"{f32['none']['flash_launches']}")
        out[f"{ARCH} {layers} layers float32"] = {
            "batch": B, "seq": S, "losses_mesh": f32["mesh"]["losses"],
            "losses_none": f32["none"]["losses"], "loss_rel_err": rel,
            "param_err": perr}
        del f32, got, want, batches

        # (a) bf16, all 24 layers: the (1, 1) mesh, then no mesh
        B, S, steps = DIST
        cfg = _h2o()
        batches = [_device_batch(torch, cfg, B, S, i, seed)
                   for i in range(steps)]
        runs = {}
        for name, mesh, sync in (("gspmd (1, 1) mesh", mesh2, "gspmd"),
                                 ("no mesh", None, "gspmd"),
                                 ("compressed_pod (1, 1, 1) mesh", mesh3,
                                  "compressed_pod")):
            r = _dist_run(torch, cfg, seed, batches, mesh, sync,
                          keep=sync == "compressed_pod",
                          profile=sync == "gspmd")
            runs[name] = r
            want = cfg.num_layers * 2 * steps
            print(f"  {ARCH} bf16 {B}x{S}, {steps} steps, {name} on {card}: "
                  f"losses {r['losses']}, step s {r['step_s']} (first "
                  f"{r['first_step_s']:.3f}, steady "
                  f"{r['steady_step_s']:.3f} = {r['tokens_per_s']:.1f} "
                  f"tok/s), memory {r['placed_memory_gb']:.2f} GB placed, "
                  f"{r['peak_memory_gb']:.2f} GB peak over the steps "
                  f"({r['peak_reserved_gb']:.2f} GB reserved), flash "
                  f"launches {r['flash_launches']} (expected {want})")
            if "profile" in r:
                pr = r["profile"]
                print(f"    one more step under torch.profiler: device busy "
                      f"{_fmt(pr['device_busy_ms'])} ms over "
                      f"{pr['device_events']} events, idle share "
                      f"{pr['idle_share']} of the steady step; top device "
                      f"ms {json.dumps(pr['top_device_ms'])}")
            if not all(math.isfinite(x) for x in r["losses"]):
                _fail(f"{ARCH} {name}: non-finite loss {r['losses']}")
            if r["flash_launches"] != want:
                _fail(f"{ARCH} {name}: flash launched {r['flash_launches']}"
                      f", expected {want}")
            launches[f"distributed {ARCH} {name}"] = r["flash_launches"]
        meshed, plain = runs["gspmd (1, 1) mesh"], runs["no mesh"]
        comp = runs.pop("compressed_pod (1, 1, 1) mesh")
        rel = max(_rel(a, b) for a, b in zip(meshed["losses"],
                                             plain["losses"]))
        gap = max(abs(a - b) for a, b in zip(comp["losses"],
                                             meshed["losses"]))
        # the fastest steady step of each: one slow step (host noise) moves
        # a mean of two
        overhead = min(meshed["step_s"][1:]) - min(plain["step_s"][1:])
        print(f"  meshed vs meshless losses {rel:.3e} relative (tol "
              f"{DIST_LOSS_RTOL}); compressed vs meshed gspmd {gap:.4f} "
              f"(tol {COMPRESSED_TOL}); the mesh's host overhead "
              f"{overhead:+.3f} s a step (fastest steady steps)")
        if not rel <= DIST_LOSS_RTOL:
            _fail(f"{ARCH} bf16: meshed losses {rel} relative off meshless")
        if not gap <= COMPRESSED_TOL:
            _fail(f"{ARCH} bf16: compressed losses {gap} off gspmd")
        # (b) the compressed run's ef, and the sync on its largest leaf
        state = comp.pop("state")
        efs = tree_leaves(_local(state.ef))
        ef_finite = all(bool(torch.isfinite(e).all()) for e in efs)
        ef_max = max(float(e.abs().max()) for e in efs)
        # the run's params and ef, on the host, for the replay below
        held = {name: [t.cpu() for t in tree_leaves(_local(tree))]
                for name, tree in (("params", state.params),
                                   ("ef", state.ef))}
        params = _local(state.params)
        _, grads = make_grad_fn(cfg)(params, batches[0])
        i = max(range(len(efs)), key=lambda j: efs[j].numel())
        g, ef = tree_leaves(grads)[i], efs[i]
        del grads, state, params
        o, ne = quantized_psum_pod(g, ef, mesh3)
        want_o, want_ef = _quantized_psum_np(np, g.float().cpu().numpy(),
                                             ef.float().cpu().numpy())
        bits = (np.array_equal(o.float().cpu().numpy(), want_o)
                and np.array_equal(ne.float().cpu().numpy(), want_ef))
        print(f"  compressed run: ef finite {ef_finite}, largest |ef| "
              f"{ef_max:.3e}; quantized_psum_pod on a {tuple(g.shape)} "
              f"{g.dtype} gradient leaf bit-equal to numpy: {bits}")
        if not (ef_finite and ef_max > 0):
            _fail(f"compressed run: ef finite {ef_finite}, max {ef_max}")
        if not bits:
            _fail("quantized_psum_pod differs from the numpy re-enactment")
        del g, ef, o, ne
        # (b) the compressed run against its arithmetic with no mesh: the
        # same losses. The gradients under the mesh and without it agree to
        # float32 rounding, and an entry that rounding moves across a
        # quantization step gets another int8 code and so another update:
        # params and ef are read, not gated
        replay = _dist_run(torch, cfg, seed, batches, None, "compressed_pod",
                           keep=True, make_step=_compressed_replay)
        rs = replay.pop("state")
        rel_r = max(_rel(a, b) for a, b in zip(replay["losses"],
                                               comp["losses"]))
        errs = {}
        for name, tree in (("params", rs.params), ("ef", rs.ef)):
            want = tree_leaves(tree)
            top = max(float(t.abs().max()) for t in want)
            errs[name] = max(float((a.to(DEVICE).float() - b.float()).abs()
                                   .max()) for a, b in zip(held[name], want)
                             ) / top
        print(f"  the compressed run against its arithmetic with no mesh: "
              f"losses {replay['losses']} ({rel_r:.3e} relative, tol "
              f"{LOSS_RTOL}); params {errs['params']:.3e} and ef "
              f"{errs['ef']:.3e} of their largest |x| (read)")
        if not rel_r <= LOSS_RTOL:
            _fail(f"compressed run off its replay: losses {rel_r} relative")
        del held, rs, replay
        torch.cuda.empty_cache()
        out[f"{ARCH} bf16"] = {
            "batch": B, "seq": S, "dtype": "bfloat16",
            **{name: r for name, r in runs.items()},
            "compressed_pod (1, 1, 1) mesh": comp,
            "loss_rel_err": rel, "compressed_gap": gap,
            "replay_loss_rel_err": rel_r, "replay_param_err": errs["params"],
            "replay_ef_err": errs["ef"],
            "mesh_overhead_s": overhead, "ef_max": ef_max,
            "sync_leaf_shape": list(want_o.shape), "sync_bit_equal": bits}
        del runs, batches
        torch.cuda.empty_cache()

        # (c) ElasticRunner: a failure at step `fail`
        arch, B, S, n, every, fail = ELASTIC
        cfg = _config(arch, param_dtype="float32", compute_dtype="float32")
        oc = OptimizerConfig(warmup=10, total_steps=n)
        batches = [_device_batch(torch, cfg, B, S, i, seed) for i in range(n)]
        finals = {}
        for name, fail_at in (("failed", {fail: 1}), ("straight", None)):
            state = adamw_init(M.init_params(
                torch.Generator(DEVICE).manual_seed(seed), cfg), oc)
            ck = StreamingCheckpointer(root / name)
            ck.save(0, state)
            step = make_train_step(cfg, oc)
            runner = ElasticRunner(make_step=lambda mesh: step,
                                   init_state=state, checkpointer=ck,
                                   ckpt_every=every)
            finals[name] = (runner.run(batches, fail_at=fail_at), runner)
        (a, ra), (b, rb) = finals["failed"], finals["straight"]
        top = max(float(p.abs().max()) for p in tree_leaves(b.params))
        perr = max(float((x - y).abs().max()) for x, y in
                   zip(tree_leaves(a.params), tree_leaves(b.params))) / top
        print(f"  {arch} float32 {B}x{S} through ElasticRunner: {n} batches, "
              f"a checkpoint every {every}, a failure at step {fail}: "
              f"{ra.recoveries} recovery, {ra.steps_done} steps run; final "
              f"params {perr:.3e} of the largest |p| off an uninterrupted "
              f"run's (tol {DIST_PARAM_TOL})")
        if not (ra.recoveries == 1 and rb.recoveries == 0 and a.step == n
                and perr <= DIST_PARAM_TOL):
            _fail(f"elastic recovery: {ra.recoveries} recoveries, step "
                  f"{a.step}, params {perr} off")
        out[f"{arch} elastic"] = {"recoveries": ra.recoveries,
                                  "steps_done": ra.steps_done,
                                  "param_err": perr}
        del finals, a, b, batches

        # (d) the all-reduce schedules at world 1
        x = torch.randn((1, 1 << 20), generator=torch.Generator(
            DEVICE).manual_seed(seed), device=DEVICE)
        flat = flat_all_reduce(x, mesh3)
        hier = hierarchical_all_reduce(x, mesh3)
        same = torch.equal(flat, x) and torch.equal(hier, x)
        print(f"  flat_all_reduce and hierarchical_all_reduce of {tuple(x.shape)}"
              f" at world 1 equal the sum: {same}")
        if not same:
            _fail("an all-reduce schedule differs from its input's sum")
        out["all_reduce_world1"] = same
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    return launches, out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _teacher_forced(cfg, params, prompts, tokens, use_kernels, cache_dtype,
                    extra=None):
    """Prefill `prompts` (B, P) (with the cross-attention input `extra`),
    then decode feeding `tokens[:, :-1]` (tokens (B, G)): the logits (B, G,
    Vp) float32 at each position, and (prefill s, decode s)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill, make_serve_step
    (B, P), G = prompts.shape, tokens.shape[1]
    caches = M.init_caches(cfg, B, P + G, dtype=cache_dtype, device=DEVICE)
    prefill = make_prefill(cfg, use_kernels=use_kernels)
    step = make_serve_step(cfg, use_kernels=use_kernels)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches = prefill(params, caches, {"tokens": prompts,
                                              "extra": extra or {}})
        out = [lg[:, -1].float()]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(1, G):
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
    print("== serve-hybrid")
    hy_launches, hybrid_stats = phase_serve_hybrid(torch, args.seed, card)
    print("== serve-xattn")
    xa_launches, xattn_stats = phase_serve_xattn(torch, args.seed, card)
    print("== train")
    train_launches, train_stats = phase_train(torch, args.seed, card)
    print("== distributed")
    dist_launches, dist_stats = phase_distributed(torch, args.seed, card)
    print("== checkpoint")
    ckpt_stats = phase_checkpoint(torch, args.seed, card)
    hy_path = f"serve {HYBRID} ({HY_LAYERS} layers)"
    xa_paths = {WHISPER: f"serve {WHISPER}",
                VLM: f"serve {VLM} ({VLM_LAYERS} layers)"}
    by_path = {name: {f"serve {ARCH}": launches[name],
                      hy_path: hy_launches[name],
                      **{path: xa_launches[m][name]
                         for m, path in xa_paths.items()}}
               for name in ("flash_attention", "decode_attention")}
    by_path["wkv6"] = {}
    for path, n in train_launches.items():
        by_path["wkv6" if RWKV in path else "flash_attention"][path] = n
    by_path["flash_attention"].update(dist_launches)
    for k in kernels:
        # each main path's own count, reset to 0 just before its run and
        # read just after; `launches` is the first such path's
        paths = by_path[k["name"]]
        k["launches_path"], k["launches"] = next(iter(paths.items()))
        k["launches_by_path"] = paths
    print(json.dumps({"kernels": kernels, "card": card,
                      "serve": serve_stats, "serve_hybrid": hybrid_stats,
                      "serve_xattn": xattn_stats,
                      "train": train_stats, "distributed": dist_stats,
                      "checkpoint": ckpt_stats}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
