"""Batched serving entry point: prefill a prompt batch, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lovelock-20m \
        --batch 4 --prompt-len 64 --gen 32 [--device cpu] [--no-kernels]

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --layers 8 --batch 4 --prompt-len 4096

`--layers` cuts the model's depth to a whole number of its periods (one
period of jamba-v0.1-52b, 8 of its 32 layers, fits one 80 GB card in bf16).

Port of `repro.launch.serve`. Runs on the CUDA card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import model as M
from repro_torch.train.steps import make_prefill, make_serve_step


def _clock(dev: torch.device) -> float:
    """Host clock after the device has finished the queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()  # simlint: ok[DET002]


def serve(cfg, *, batch, prompt_len, gen, seed=0, use_kernels=True,
          device=None, params=None, prompts=None):
    """Prefill `batch` prompts of `prompt_len` tokens, then decode greedily.

    The first generated token comes from the prefill, the other gen-1 from
    decode steps. `params` and `prompts` (int, (batch, prompt_len)) default
    to random ones made from `seed`. Returns (tokens (batch, gen), stats,
    logits (batch, gen, Vp) float32: the logits each token was chosen from).
    """
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                               tp=1)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len), device=dev,
            generator=torch.Generator(dev).manual_seed(seed + 1))
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts have shape {tuple(prompts.shape)}, "
                         f"expected {(batch, prompt_len)}")
    prompts = prompts.to(dev)
    caches = M.init_caches(cfg, batch, prompt_len + gen, tp=1, device=dev)
    prefill = make_prefill(cfg, use_kernels=use_kernels)
    step = make_serve_step(cfg, use_kernels=use_kernels)

    with torch.no_grad():
        t0 = _clock(dev)
        logits, caches = prefill(params, caches, {"tokens": prompts})
        tok = logits[:, -1].argmax(-1)[:, None]
        t_prefill = _clock(dev) - t0

        out, picked = [tok], [logits[:, -1].float()]
        t0 = _clock(dev)
        t_first = 0.0
        for i in range(gen - 1):
            tok, caches, last = step(params, caches, tok)
            out.append(tok)
            picked.append(last.float())
            if i == 0:
                t_first = _clock(dev) - t0
        t_decode = _clock(dev) - t0
    stats = {
        "prefill_s": t_prefill,
        "prefill_tokens_per_s": batch * prompt_len / t_prefill,
        "decode_s": t_decode,
        "decode_tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        # the first decode step pays first-use costs (lazy loads, library
        # heuristics for the new shapes); the steady state excludes it
        "decode_first_step_s": t_first,
    }
    if gen > 2:
        stats["decode_steady_step_s"] = (t_decode - t_first) / (gen - 2)
        stats["decode_steady_tokens_per_s"] = (
            batch / max(stats["decode_steady_step_s"], 1e-9))
    return torch.cat(out, dim=1), stats, torch.stack(picked, dim=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lovelock-20m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain PyTorch attention instead of the kernels")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve this many layers (a multiple of the "
                         "model's period) instead of the config's")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    toks, stats, _ = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           gen=args.gen, seed=args.seed,
                           use_kernels=not args.no_kernels,
                           device=args.device)
    print("generated shape:", tuple(toks.shape))
    for k, v in stats.items():
        print(f"  {k}: {v:.2f}")


if __name__ == "__main__":
    main()
