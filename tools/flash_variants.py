#!/usr/bin/env python3
"""Build variants of a kernel's CUDA source, check them, time them.

    [KERNEL=flash|decode|wkv6] python3 tools/flash_variants.py \
        NAME=SOURCE[@@OLD=>NEW ...] ...

Run from the root of a checkout on a machine with one NVIDIA card and nvcc.
KERNEL (default flash) names the C entry the variants share:
`flash_attention_fwd`, `decode_attention_fwd` or `wkv6_fwd` of
src/repro_torch/kernels/*/csrc/. Each argument names a variant: a `.cu`
file with that entry, and text substitutions applied to it in order
(`OLD=>NEW`, joined by `@@`; a literal backslash-n is a newline).
For example, the committed flash kernel against the same kernel with a
three-stage ring:

    python3 tools/flash_variants.py \
        now=src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu \
        'stages3=src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu@@constexpr int STAGES = 4;=>constexpr int STAGES = 3;'

All variants are compiled at once (the package's nvcc flags, into
build/variants/), with ptxas's register, spill and performance lines
printed for the main path's head dim. Each is then held against the plain
version run in float32 to the gate of chip_smoke.py phase 3 and timed at
its main path's shape, three rounds in alternating order, so that variants
are compared only within one run on one card:

- flash: bf16 cases, timed by CUDA events at h2o-danube-1.8b's prefill
  shape (B=4, S=4160, H=32, K=8, d=80, window 4096);
- decode: the three (q, cache) dtype pairs on chip_smoke.py's sweep, an
  all-masked split and h2o's shape; each pair timed at h2o's decode shape
  (B=4, W=4096, H=32, K=8, d=80; bf16 is the serve path's) over 8 caches
  (L2 cold), by CUDA events and device-only by torch.profiler;
- wkv6: the reference's sweep, S one above and below a 32-token chunk,
  the strong-decay cases; timed at rwkv6-7b's training shape (B=4, H=64,
  S=2048, d=64), by CUDA events and device-only.

NOCHECK=1 skips the checks; SDPA=1 also times PyTorch's
scaled_dot_product_attention at the flash or decode shape.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_ref  # noqa: E402

OUT = ROOT / "build" / "variants"
H2O = (4, 4160, 32, 8, 80, True, 4096)   # B, S, H, K, d, causal, window
CASES = [(2, 300, 8, 2, d, True, 100) for d in (32, 64, 80, 112, 128)] + [
    (2, 300, 8, 8, 64, False, None), (2, 300, 8, 1, 80, True, None),
    (2, 300, 8, 4, 112, False, 100), (2, 200, 4, 1, 80, True, 96), H2O]
TOL, REL = 2e-5, 2.0 ** -8               # chip_smoke.py phase 3
H2O_DECODE = (4, 4096, 32, 8, 80)        # B, W, H, K, d
DECODE_CASES = [(2, 512, 4, 2, 64), (1, 300, 8, 8, 128), (2, 1000, 4, 1, 80),
                (1, 1024, 16, 1, 64), H2O_DECODE]
RWKV_TRAIN = (4, 64, 2048, 64)           # B, H, S, d
WKV6_CASES = [(2, 2, 128, 32), (1, 4, 100, 64), (2, 1, 64, 16),
              (1, 2, 65, 64), (2, 2, 31, 64), (1, 3, 33, 32), RWKV_TRAIN]
WKV6_TOL = 1e-4
ENTRY = {"flash": ("flash_attention_fwd", fops.ARGTYPES, "bf16_kernelILi"),
         "decode": ("decode_attention_fwd", dops.ARGTYPES, "Li80E"),
         "wkv6": ("wkv6_fwd", wops.ARGTYPES, "wkv6_fwd_kernel")}
DECODE_PAIRS = [(torch.bfloat16, torch.bfloat16),   # (q, cache)
                (torch.float32, torch.float32),
                (torch.float32, torch.bfloat16)]


def build(args, kernel) -> dict:
    entry_fn, argtypes, mark = ENTRY[kernel]
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for arg in args:
        name, spec = arg.split("=", 1)
        path, *subs = spec.split("@@")
        src = (ROOT / path).read_text()
        for sub in subs:
            old, new = (x.replace("\\n", "\n") for x in sub.split("=>"))
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in {path}")
            src = src.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(src)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.INCLUDE_DIR}",
               f"-I{(ROOT / path).parent}", "-o", str(so), str(cu)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n" + "\n".join(
                log.splitlines()[:25]))
            continue
        entry = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if mark in line else None
            elif entry and ("Used" in line or "spill" in line):
                short = entry[entry.find("kernelI"):][:40]
                print(f"{name} {short}: {line.strip()}")
            if "Performance" in line:
                print(f"{name}: {line.strip()[:200]}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry_fn)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _check(err):
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def call(lib, q, k, v, causal, window):
    B, S, H, d = q.shape
    o = torch.empty_like(q)
    _check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], d, 1, int(causal), window or 0, 1.0 / math.sqrt(d),
        _stream()))
    return o


def call_decode(lib, q, k, v, bias):
    B, _, H, d = q.shape
    W, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    codes = (dops._launch.DTYPE_CODES[q.dtype],
             dops._launch.DTYPE_CODES[k.dtype])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per, _ = dops.split_plan(W, B, K, n_sm)
    _check(lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, W, H, K, d, *codes, per, 1.0 / math.sqrt(d),
        _stream()))
    return out


def call_wkv6(lib, r, k, v, logw, u):
    B, H, S, d = r.shape
    o = torch.empty_like(r)
    s = torch.empty((B, H, d, d), device="cuda")
    _check(lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        logw.data_ptr(), u.data_ptr(), o.data_ptr(),
                        s.data_ptr(), B, H, S, d, _stream()))
    return o, s


def inputs(gen, B, S, H, K, d):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for shape in ((B, S, H, d), (B, S, K, d), (B, S, K, d))]


def decode_inputs(gen, B, W, H, K, d, qt, ct):
    q = torch.randn((B, 1, H, d), generator=gen, device="cuda").to(qt)
    k, v = (torch.randn((B, W, K, d), generator=gen, device="cuda").to(ct)
            for _ in range(2))
    valid = torch.rand((B, W), generator=gen, device="cuda") < 0.8
    valid[:, :W // 4] = False       # a quarter masked: whole splits at once
    bias = torch.full((B, W), -1e30, device="cuda").masked_fill_(valid, 0.0)
    return q, k, v, bias


def wkv6_inputs(gen, B, H, S, d, logw=None):
    r, k, v = (torch.randn((B, H, S, d), generator=gen, device="cuda") * 0.5
               for _ in range(3))
    lw = -torch.exp(torch.randn((B, H, S, d), generator=gen, device="cuda")
                    * 0.5 - 1.0)
    u = torch.randn((H, d), generator=gen, device="cuda") * 0.5
    if logw is not None:
        lw, u = torch.full_like(lw, logw), torch.zeros_like(u)
    return r, k, v, lw, u


def time_ms(fn, reps=20) -> float:
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Device time a call: the union of the device spans torch.profiler
    records over `reps` calls; None if it records none."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / reps / 1e3 if busy else None


def held(out, gold) -> float:
    rel = REL if out.dtype == torch.bfloat16 else 0.0
    return ((out.float() - gold).abs() - rel * gold.abs()).max().item()


def check_flash(libs, gen) -> bool:
    ok = True
    for name, lib in libs.items():
        worst = 0.0
        for B, S, H, K, d, causal, win in CASES:
            q, k, v = inputs(gen, B, S, H, K, d)
            o = call(lib, q, k, v, causal, win)
            torch.cuda.synchronize()
            worst = max(worst, held(o, flash_attention_ref(
                q.float(), k.float(), v.float(), causal=causal, window=win)))
        ok &= worst <= TOL
        print(f"{name}: beyond the relative part {worst:.3e} "
              f"({'ok' if worst <= TOL else 'FAILS'} at {TOL})")
    return ok


def check_decode(libs, gen) -> bool:
    ok = True
    for name, lib in libs.items():
        worst = 0.0
        for case in DECODE_CASES:
            for qt, ct in DECODE_PAIRS:
                q, k, v, bias = decode_inputs(gen, *case, qt, ct)
                o = call_decode(lib, q, k, v, bias)
                torch.cuda.synchronize()
                worst = max(worst, held(o, decode_attention_ref(
                    q.float(), k.float(), v.float(), bias)))
        ok &= worst <= TOL
        print(f"{name}: beyond the relative part {worst:.3e} "
              f"({'ok' if worst <= TOL else 'FAILS'} at {TOL})")
    return ok


def check_wkv6(libs, gen) -> bool:
    ok = True
    for name, lib in libs.items():
        worst = 0.0
        for case in WKV6_CASES + [(1, 1, 128, 32, -30.0),
                                  (1, 1, 128, 32, -1e-6)]:
            x = wkv6_inputs(gen, *case)
            o, s = call_wkv6(lib, *x)
            torch.cuda.synchronize()
            ro, rs = wkv6_ref(*x, torch.zeros_like(s))
            rtol = 1e-5 if len(case) == 5 else 0.0
            finite = bool(torch.isfinite(o).all() and torch.isfinite(s).all())
            worst = max(worst, float("inf") if not finite else max(
                ((a - b).abs() - rtol * b.abs()).max().item()
                for a, b in ((o, ro), (s, rs))))
        ok &= worst <= WKV6_TOL
        print(f"{name}: beyond the relative part {worst:.3e} "
              f"({'ok' if worst <= WKV6_TOL else 'FAILS'} at {WKV6_TOL})")
    return ok


def timed(libs, calls, what):
    """Three rounds in alternating order: CUDA-event ms, then device-only
    ms, each variant's."""
    times = {n: [] for n in libs}
    dev = {n: [] for n in libs}
    for rnd in range(3):
        for n in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            times[n].append(time_ms(calls[n], 40))
            dev[n].append(device_ms(calls[n], 40))
    for n in libs:
        print(f"{n}: events {' '.join(f'{x:.4f}' for x in times[n])} ms, "
              f"device only {' '.join(f'{x:.4f}' for x in dev[n] if x)} "
              f"ms at {what}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    kernel = os.environ.get("KERNEL", "flash")
    libs = build(sys.argv[1:], kernel)
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    if not os.environ.get("NOCHECK"):
        ok = {"flash": check_flash, "decode": check_decode,
              "wkv6": check_wkv6}[kernel](libs, gen)
    if kernel == "decode":
        B, W, H, K, d = H2O_DECODE
        for qt, ct in DECODE_PAIRS:
            q, _, _, bias = decode_inputs(gen, *H2O_DECODE, qt, ct)
            bias.zero_()             # the last decode step's ring: all valid
            ks = [torch.randn((B, W, K, d), generator=gen,
                              device="cuda").to(ct) for _ in range(8)]
            vs = [torch.randn_like(x) for x in ks]
            timed(libs, {n: (lambda i, lib=lib: call_decode(
                lib, q, ks[i % 8], vs[i % 8], bias))
                for n, lib in libs.items()},
                f"{list(H2O_DECODE)} q {qt}, cache {ct}, 8 caches")
            if os.environ.get("SDPA") and qt == ct:
                import torch.nn.functional as F
                qh, mask = q.transpose(1, 2), bias[:, None, None, :]

                def sdpa(i):
                    return F.scaled_dot_product_attention(
                        qh, ks[i % 8].transpose(1, 2),
                        vs[i % 8].transpose(1, 2), attn_mask=mask,
                        enable_gqa=True)
                print(f"SDPA, {qt}: events {time_ms(sdpa, 40):.4f} ms, "
                      f"device only {device_ms(sdpa, 40):.4f} ms")
            del ks, vs
        return 0 if ok else 1
    if kernel == "wkv6":
        x = wkv6_inputs(gen, *RWKV_TRAIN)
        timed(libs, {n: (lambda i, lib=lib: call_wkv6(lib, *x))
                     for n, lib in libs.items()},
              f"{list(RWKV_TRAIN)} float32")
        return 0 if ok else 1
    B, S, H, K, d, causal, win = H2O
    q, k, v = inputs(gen, B, S, H, K, d)
    times = {n: [] for n in libs}
    for rnd in range(3):
        for n in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            times[n].append(time_ms(lambda i: call(libs[n], q, k, v, causal,
                                                   win)))
    for n, t in times.items():
        print(f"{n}: {' '.join(f'{x:.4f}' for x in t)} ms at {list(H2O)}")
    if os.environ.get("SDPA"):
        import torch.nn.functional as F
        pos = torch.arange(S, device="cuda")
        dlt = pos[:, None] - pos[None, :]
        allowed = (dlt >= 0) & (dlt < win)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        print(f"SDPA: {time_ms(lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed, enable_gqa=True), 5):.4f} ms")  # noqa: E501
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
