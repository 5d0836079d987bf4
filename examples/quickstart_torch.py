"""Quickstart on the PyTorch port: train a tiny model for a few steps, then
generate (twin of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--no-kernels]

Runs on the CUDA card unless `--device cpu`. The model is qwen3-32b's
smoke variant; its head dim of 16 is one the attention kernels do not
take (they take 32/64/80/112/128), so on the card it runs with head dim
32 through the flash and decode-attention kernels. On the CPU the
kernels' plain versions run and the head dim stays 16.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import model as M
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.train.steps import (make_prefill, make_serve_step,
                                     make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain PyTorch attention instead of the kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config("qwen3-32b"))
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=32)
    kernels = not args.no_kernels
    print(f"model: {cfg.name} (head dim {cfg.head_dim})  "
          f"params={cfg.param_count()[0]/1e6:.1f}M  device={dev}  "
          f"kernels={kernels}")
    oc = OptimizerConfig(lr=1e-3)
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, tp=1)
    state = adamw_init(params, oc)
    step = make_train_step(cfg, oc, use_kernels=kernels)
    toks = torch.randint(0, cfg.vocab_size, (4, 65), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for i in range(args.steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 3 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")

    # generation: prefill a prompt, decode 12 tokens greedily
    B, P, G = 2, 16, 12
    caches = M.init_caches(cfg, B, P + G, tp=1, device=dev)
    prefill = make_prefill(cfg, use_kernels=kernels)
    decode = make_serve_step(cfg, use_kernels=kernels)
    with torch.no_grad():
        logits, caches = prefill(state.params, caches,
                                 {"tokens": toks[:B, :P]})
        tok = logits[:, -1].argmax(-1)[:, None]
        outs = [tok]
        for _ in range(G - 1):
            tok, caches, _ = decode(state.params, caches, tok)
            outs.append(tok)
    gen = torch.cat(outs, dim=1)
    print("generated token ids:", gen.tolist())
    return {"losses": losses, "tokens": gen}


if __name__ == "__main__":
    main()
