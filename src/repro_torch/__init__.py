"""PyTorch / CUDA port of the `repro` model stack: the serve and train
paths of every model family (dense decoders, MoE, the Mamba + attention
hybrid, RWKV6, the cross-attention VLM and whisper's encoder-decoder),
and the streaming checkpointer.

The package mirrors `repro`: `configs/`, `models/`, `train/steps.py`,
`optim/`, `data/`, `core/elastic.py`, `launch/{serve,train}.py` and
`kernels/<name>/{ops.py, ref.py, csrc/*.cu}`. It imports `torch` and never
`jax` or `repro`.

Entry points run on the card unless the caller passes `device="cpu"`;
they never fall back to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; the default is the CUDA card.

    Raises when a CUDA device is asked for (or defaulted to) and none is
    available: the caller must pass `device="cpu"` to run on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU")
    return dev
