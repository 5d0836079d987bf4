"""Batched serving entry point: prefill a prompt batch, decode N tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lovelock-20m \
        --batch 4 --prompt-len 64 --gen 32 [--device cpu] [--no-kernels]

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --layers 8 --batch 4 --prompt-len 4096

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --batch 4 --prompt-len 224

`--layers` cuts the model's depth to a whole number of its periods (one
period of jamba-v0.1-52b, 8 of its 32 layers, or of llama-3.2-vision-90b,
5 of its 100, fits one 80 GB card in bf16); for whisper it cuts the
decoder only. The cross-attention families are fed zero image embeddings
or audio frames, as the reference's serve feeds them.

Port of `repro.launch.serve`. Runs on the CUDA card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import torch

from repro_torch import obs, resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import model as M
from repro_torch.train.steps import make_prefill, make_serve_step

# the batch id of each `serve` call's spans (`obs`)
_BATCH_IDS = itertools.count()


def _clock(dev: torch.device) -> float:
    """Host clock after the device has finished the queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()  # simlint: ok[DET002]


def _zero_extra(cfg, batch, device) -> dict:
    """The reference serve's cross-attention input: zero bf16 image
    embeddings (VLM) or audio frames (whisper), {} for other families."""
    extra = {}
    if cfg.cross_attn_every:
        extra["image_embeds"] = torch.zeros(
            (batch, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    if cfg.encoder_layers:
        extra["audio_frames"] = torch.zeros(
            (batch, cfg.num_audio_frames, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    return extra


def serve(cfg, *, batch, prompt_len, gen, seed=0, use_kernels=True,
          device=None, params=None, prompts=None, extra=None):
    """Prefill `batch` prompts of `prompt_len` tokens, then decode greedily.

    The first generated token comes from the prefill, the other gen-1 from
    decode steps. `params` and `prompts` (int, (batch, prompt_len)) default
    to random ones made from `seed`; `extra` (the cross-attention families'
    "image_embeds" or "audio_frames") to `_zero_extra`'s. Returns (tokens
    (batch, gen), stats, logits (batch, gen, Vp) float32: the logits each
    token was chosen from).
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
    if extra is None:
        extra = _zero_extra(cfg, batch, dev)
    batch_in = {"tokens": prompts,
                "extra": {k: v.to(dev) for k, v in extra.items()}}
    caches = M.init_caches(cfg, batch, prompt_len + gen, tp=1, device=dev)
    prefill = make_prefill(cfg, use_kernels=use_kernels)
    step = make_serve_step(cfg, use_kernels=use_kernels)

    with torch.no_grad(), obs.span("serve.batch", batch=next(_BATCH_IDS),
                                   B=batch, prompt_len=prompt_len, gen=gen):
        t0 = _clock(dev)
        with obs.span("serve.prefill"):
            logits, caches = prefill(params, caches, batch_in)
            tok = logits[:, -1].argmax(-1)[:, None]
            t_prefill = _clock(dev) - t0

        out, picked = [tok], [logits[:, -1].float()]
        t0 = _clock(dev)
        for i in range(gen - 1):
            with obs.span("serve.decode_step", step=i):
                tok, caches, last = step(params, caches, tok)
            out.append(tok)
            picked.append(last.float())
        t_decode = _clock(dev) - t0
    stats = {
        "prefill_s": t_prefill,
        "prefill_tokens_per_s": batch * prompt_len / t_prefill,
        "decode_s": t_decode,
        "decode_tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }
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
                         "model's period; whisper: decoder layers) instead "
                         "of the config's")
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
