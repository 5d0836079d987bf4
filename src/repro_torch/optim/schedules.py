"""LR schedules (port of `repro.optim.schedules`): pure functions of the
step, computed in float32 as the reference computes them."""
import torch


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """lr(step: int) -> float: linear warmup, then cosine decay to
    min_ratio * base_lr at `total`."""
    def lr(step) -> float:
        step = torch.tensor(step, dtype=torch.float32)
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(torch.pi * t))
        return float(torch.where(step < warmup, warm, base_lr * cos))
    return lr
