"""End-to-end training of the ~100M reference model on the PyTorch port
(twin of examples/train_e2e.py).

Full run (a few hundred steps; writes artifacts/train_100m_torch.jsonl):

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 250

Quick check:

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 10 --batch 4 \
        --seq 128 [--device cpu] [--no-kernels]

Runs on the CUDA card unless `--device cpu`; lovelock-100m's head dim is
64, so on the card its attention is the flash kernel unless `--no-kernels`.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_100m_torch",
                    help="checkpoint directory ('' for no checkpoints)")
    ap.add_argument("--log-path", default="artifacts/train_100m_torch.jsonl")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain PyTorch attention instead of the kernels")
    args = ap.parse_args(argv)
    cfg = get_config("lovelock-100m")
    total, _ = cfg.param_count()
    print(f"training {cfg.name}: {total/1e6:.0f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq}")
    state, info = train_loop(cfg, steps=args.steps, batch=args.batch,
                             seq=args.seq, ckpt_dir=args.ckpt_dir or None,
                             log_path=args.log_path, device=args.device,
                             use_kernels=not args.no_kernels)
    losses = info["losses"]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    return info


if __name__ == "__main__":
    main()
