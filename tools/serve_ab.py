#!/usr/bin/env python3
"""Time the cross-attention serve cells' prefill for two or more checkouts.

    python3 tools/serve_ab.py [--reps N] [--gen G] ROOT [ROOT ...]

Run on a machine with one NVIDIA card and nvcc. Each ROOT is the root of a
checkout of this repo (`.` for the one in hand; an older commit unpacked
with `git archive` under the git-ignored `build/`). The checkouts run one
after another, in the order given, each in a process of its own that
imports `repro_torch` from ROOT/src and builds its kernels under
ROOT/build/. Pass the roots as A B B A so that each is measured early and
late in the call.

Each process serves, as chip_smoke.py phase `serve-xattn` does (seed 0,
batch 4, bf16 random weights): whisper-large-v3 whole with 1500 random
frames and a 224-token prompt, and llama-3.2-vision-90b cut to one period
(5 of 100 layers) with 1601 random image embeddings, the gate at 1 and a
4096-token prompt; each `reps` times, `gen` tokens a time (`--device cpu
--smoke` rehearses the script on smoke variants). It prints one
JSON line per model: every prefill's seconds (the first is the one
chip_smoke.py reads: the first at its shapes in the process), their
minimum and median, and the steady decode step (the median of the steps
past the first, each step timed around its call by CUDA events, by the
host clock on the CPU: the same in every checkout, with the program's
own tracing off). A last line prints each root's readings side by side.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

BATCH, WH_PROMPT, VLM_PROMPT, VLM_LAYERS = 4, 224, 4096, 5


def child(root: Path, reps: int, gen: int, device: str,
          smoke: bool) -> None:
    sys.path.insert(0, str(root / "src"))
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    dev = device
    step_s = _time_steps(torch, S, dev)
    for arch, layers, prompt, key in (
            ("whisper-large-v3", None, WH_PROMPT, "audio_frames"),
            ("llama-3.2-vision-90b", VLM_LAYERS, VLM_PROMPT,
             "image_embeds")):
        cfg = get_config(arch)
        if smoke:
            cfg, prompt = smoke_variant(cfg), 16
        elif layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if dev == "cuda":
            torch.cuda.empty_cache()
        params = M.init_params(torch.Generator(dev).manual_seed(0), cfg)
        for i, spec in enumerate(M.block_specs(cfg)):
            if spec["kind"] == "xattn":
                params["layers"][i]["attn"]["gate"].fill_(1.0)
        prompts = torch.randint(0, cfg.vocab_size, (BATCH, prompt),
                                device=dev,
                                generator=torch.Generator(dev).manual_seed(1))
        n_src = (cfg.num_audio_frames if key == "audio_frames"
                 else cfg.num_image_tokens)
        src = torch.randn((BATCH, n_src, cfg.d_model), device=dev,
                          generator=torch.Generator(dev).manual_seed(3)
                          ).to(torch.bfloat16)
        prefill, steady = [], []
        for _ in range(reps):
            _, stats, _ = S.serve(cfg, batch=BATCH, prompt_len=prompt,
                                  gen=gen, device=dev, params=params,
                                  prompts=prompts, extra={key: src})
            prefill.append(stats["prefill_s"])
            steps = step_s()
            steady.append(statistics.median(steps[1:])
                          if len(steps) > 1 else None)
        print(json.dumps({"root": str(root), "arch": arch,
                          "prefill_s": prefill, "min": min(prefill),
                          "median": statistics.median(prefill),
                          "decode_steady_step_s": steady}), flush=True)
        del params


def _time_steps(torch, S, dev):
    """Makes `serve` (module `S`) time each decode step: its factory
    `make_serve_step` is wrapped for the rest of the process. Returns a
    function that gives the seconds of the steps since its last call."""
    import time
    real, marks = S.make_serve_step, []

    def mark():
        if dev != "cuda":
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def make(*a, **k):
        step = real(*a, **k)

        def call(*args, **kwargs):
            start = mark()
            out = step(*args, **kwargs)
            marks.append((start, mark()))
            return out
        return call
    S.make_serve_step = make

    def taken():
        if dev == "cuda":
            torch.cuda.synchronize()
            out = [s.elapsed_time(e) / 1e3 for s, e in marks]
        else:
            out = [e - s for s, e in marks]
        marks.clear()
        return out
    return taken


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke variants at prompt 16: a CPU rehearsal")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child).resolve(), args.reps, args.gen, args.device,
              args.smoke)
        return 0
    if not args.roots:
        ap.error("name at least one checkout root")
    rows = []
    for root in args.roots:
        p = subprocess.run(
            [sys.executable, __file__, "--child", root, "--reps",
             str(args.reps), "--gen", str(args.gen), "--device",
             args.device] + ["--smoke"] * args.smoke,
            capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode != 0:
            sys.stderr.write(p.stderr)
            return p.returncode
        rows += [json.loads(line) for line in p.stdout.splitlines()
                 if line.startswith("{")]
    # per (turn, root, model): min, median and first prefill seconds
    print(json.dumps([[i // 2, r["root"], r["arch"], r["min"], r["median"],
                       r["prefill_s"][0]] for i, r in enumerate(rows)]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
