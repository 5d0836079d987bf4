"""Batched serving on the PyTorch port: prefill + greedy decode with KV
caches (twin of examples/serve_batched.py).

    PYTHONPATH=src python examples/serve_batched_torch.py [--arch rwkv6-7b]
        [--device cpu] [--no-kernels]

Runs on the CUDA card unless `--device cpu`. The model is the arch's smoke
variant; its head dim of 16 is one the attention kernels do not take
(they take 32/64/80/112/128), so on the card it runs with head dim 32. For
rwkv6-7b that is the WKV head size, whose prefill and decode take the
chunked form (the kernel starts from a zero state only); a dense arch
(`--arch qwen3-32b`) serves through the flash and decode-attention
kernels.
"""
import argparse
import dataclasses

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain PyTorch attention instead of the kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_variant(get_config(args.arch))
    if dev.type == "cuda":
        cfg = dataclasses.replace(cfg, head_dim=32)
    toks, stats, _ = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           gen=args.gen, use_kernels=not args.no_kernels,
                           device=dev)
    print(f"arch={args.arch} (smoke, head dim {cfg.head_dim}) on {dev} "
          f"generated {tuple(toks.shape)}")
    for k, v in stats.items():
        print(f"  {k}: {v:.2f}")
    return {"tokens": toks, "stats": stats}


if __name__ == "__main__":
    main()
