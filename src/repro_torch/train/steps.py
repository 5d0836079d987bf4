"""Serve-step factories (port of `repro.train.steps`: make_prefill and
make_serve_step; the train step comes with the training slice)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill(cfg: ModelConfig, *, use_kernels=True):
    def prefill(params, caches, batch):
        logits, _, caches = M.forward(params, cfg, batch["tokens"],
                                      caches=caches, use_kernels=use_kernels)
        return logits[:, -1:], caches
    return prefill


def make_serve_step(cfg: ModelConfig, *, use_kernels=True):
    """serve_step(params, caches, token) -> (next_token, caches, logits).

    Greedy: the next token is the argmax over the real vocabulary (padded
    ids masked). `logits` (B, Vp) are the last position's, before the
    vocab mask; the reference returns only (next_token, caches).
    """
    def serve_step(params, caches, token):
        logits, caches = M.decode_step(params, cfg, token, caches,
                                       use_kernels=use_kernels)
        last = logits[:, -1]
        scores = last.float()
        Vp = scores.shape[-1]
        if Vp != cfg.vocab_size:
            pad = torch.arange(Vp, device=scores.device) >= cfg.vocab_size
            scores = scores.masked_fill(pad, -1e30)
        return scores.argmax(-1)[:, None], caches, last
    return serve_step
