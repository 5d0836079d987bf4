"""Train and serve step factories (port of `repro.train.steps`:
cross_entropy, make_train_step, make_prefill, make_serve_step)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim.adamw import (OptimizerConfig, TrainState,
                                     adamw_update)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def cross_entropy(logits, labels, vocab_size: int):
    """Mean CE over tokens in float32; the padded vocab tail is masked
    out."""
    logits = logits.float()
    Vp = logits.shape[-1]
    if Vp != vocab_size:
        neg = torch.where(torch.arange(Vp, device=logits.device) < vocab_size,
                          0.0, -1e30)
        logits = logits + neg
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    return torch.mean(logz - gold)


def make_grad_fn(cfg: ModelConfig, *, use_kernels=True, remat=True,
                 microbatches: int = 1):
    """grad_fn(params, batch) -> (metrics, grads): the loss's gradient with
    respect to every leaf of `params`, in the params' tree and dtypes
    (float32 when microbatches > 1).

    batch: {"tokens", "labels"} (B, S) integer tensors, and "extra" for
    the cross-attention families (see `models.model.forward`).
    microbatches > 1: gradient accumulation over k sequential slices of
    the batch in a float32 accumulator, the mean of the k gradients.
    """
    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits, aux, _ = M.forward(live, cfg, batch["tokens"],
                                   extra=batch.get("extra"),
                                   use_kernels=use_kernels, remat=remat)
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        grads = torch.autograd.grad(ce + aux, tree_leaves(live))
        return ({"loss": ce.detach(), "aux": aux.detach()},
                tree_unflatten(params, grads))

    def grad_fn(params, batch):
        if microbatches <= 1:
            return value_and_grad(params, batch)
        k = microbatches
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        ms = []
        for i in range(k):
            mb = tree_map(lambda x: x.reshape(
                (k, x.shape[0] // k) + x.shape[1:])[i], batch)
            metrics, g = value_and_grad(params, mb)
            tree_map(lambda a, x: a.add_(x.float()), acc, g)
            ms.append(metrics)
        grads = tree_map(lambda a: a / k, acc)
        return {n: torch.stack([m[n] for m in ms]).mean()
                for n in ms[0]}, grads
    return grad_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    use_kernels=True, remat=True, grad_sync: str = "gspmd",
                    microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place (see `adamw_update`).

    One device only: grad_sync='gspmd' is the reference's single-device
    path; its 'compressed_pod' sync is not ported yet.
    """
    if grad_sync == "compressed_pod":
        raise NotImplementedError(
            "grad_sync='compressed_pod' (the int8 error-feedback cross-pod "
            "all-reduce) is not ported yet: ROADMAP.md queue 1 item 9")
    if grad_sync != "gspmd":
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    lr_fn = cosine_schedule(opt_cfg.lr, opt_cfg.warmup, opt_cfg.total_steps)
    grad_fn = make_grad_fn(cfg, use_kernels=use_kernels, remat=remat,
                           microbatches=microbatches)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        metrics, grads = grad_fn(state.params, batch)
        return adamw_update(state, grads, opt_cfg, lr_fn), metrics
    return train_step


def make_prefill(cfg: ModelConfig, *, use_kernels=True):
    def prefill(params, caches, batch):
        logits, _, caches = M.forward(params, cfg, batch["tokens"],
                                      extra=batch.get("extra"),
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
