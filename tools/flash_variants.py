#!/usr/bin/env python3
"""Build variants of the flash-attention CUDA source, check them, time them.

    python3 tools/flash_variants.py NAME=SOURCE[@@OLD=>NEW ...] ...

Run from the root of a checkout on a machine with one NVIDIA card and nvcc.
Each argument names a variant: a `.cu` file with the C entry
`flash_attention_fwd` of src/repro_torch/kernels/flash_attention/csrc/, and
text substitutions applied to it in order (`OLD=>NEW`, joined by `@@`; a
literal backslash-n in NEW is a newline). For example, the committed kernel
against the same kernel with a three-stage ring:

    python3 tools/flash_variants.py \\
        now=src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu \\
        'stages3=src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu@@constexpr int STAGES = 4;=>constexpr int STAGES = 3;'

All variants are compiled at once (the package's nvcc flags, into
build/variants/), with ptxas's register, spill and performance lines
printed for d = 80 and 128. Each is then held against the plain version
run in float32 on a few bf16 cases, to the gate of chip_smoke.py phase 3,
and timed by CUDA events at h2o-danube-1.8b's prefill shape (B=4, S=4160,
H=32, K=8, d=80, window 4096), three rounds in alternating order, so that
variants are compared only within one run on one card. NOCHECK=1 skips the
checks; SDPA=1 also times PyTorch's scaled_dot_product_attention there.
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
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)

OUT = ROOT / "build" / "variants"
H2O = (4, 4160, 32, 8, 80, True, 4096)   # B, S, H, K, d, causal, window
CASES = [(2, 300, 8, 2, d, True, 100) for d in (32, 64, 80, 112, 128)] + [
    (2, 300, 8, 8, 64, False, None), (2, 300, 8, 1, 80, True, None),
    (2, 300, 8, 4, 112, False, 100), (2, 200, 4, 1, 80, True, 96), H2O]
TOL, REL = 2e-5, 2.0 ** -8               # chip_smoke.py phase 3


def build(args) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = []
    for arg in args:
        name, spec = arg.split("=", 1)
        path, *subs = spec.split("@@")
        src = (ROOT / path).read_text()
        for sub in subs:
            old, new = sub.split("=>")
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in {path}")
            src = src.replace(old, new.replace("\\n", "\n"))
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
                entry = next((f"d{d}" for d in (80, 128)
                              if f"bf16_kernelILi{d}E" in line), None)
            elif entry and ("Used" in line or "spill" in line):
                print(f"{name} {entry}: {line.strip()}")
            if "Performance" in line:
                print(f"{name}: {line.strip()[:200]}")
        lib = ctypes.CDLL(str(so))
        lib.flash_attention_fwd.argtypes = fops.ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, q, k, v, causal, window):
    B, S, H, d = q.shape
    o = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
        k.shape[2], d, 1, int(causal), window or 0, 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return o


def inputs(gen, B, S, H, K, d):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for shape in ((B, S, H, d), (B, S, K, d), (B, S, K, d))]


def time_ms(fn, reps=20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(sys.argv[1:])
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    for name, lib in ([] if os.environ.get("NOCHECK") else libs.items()):
        worst = 0.0
        for B, S, H, K, d, causal, win in CASES:
            q, k, v = inputs(gen, B, S, H, K, d)
            o = call(lib, q, k, v, causal, win)
            torch.cuda.synchronize()
            gold = flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal, window=win)
            worst = max(worst, ((o.float() - gold).abs()
                                - REL * gold.abs()).max().item())
        ok &= worst <= TOL
        print(f"{name}: beyond the relative part {worst:.3e} "
              f"({'ok' if worst <= TOL else 'FAILS'} at {TOL})")
    B, S, H, K, d, causal, win = H2O
    q, k, v = inputs(gen, B, S, H, K, d)
    times = {n: [] for n in libs}
    for rnd in range(3):
        for n in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
            times[n].append(time_ms(lambda: call(libs[n], q, k, v, causal,
                                                 win)))
    for n, t in times.items():
        print(f"{n}: {' '.join(f'{x:.4f}' for x in t)} ms at {list(H2O)}")
    if os.environ.get("SDPA"):
        import torch.nn.functional as F
        pos = torch.arange(S, device="cuda")
        dlt = pos[:, None] - pos[None, :]
        allowed = (dlt >= 0) & (dlt < win)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        print(f"SDPA: {time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed, enable_gqa=True), 5):.4f} ms")  # noqa: E501
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
