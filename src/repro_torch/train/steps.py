"""Train and serve step factories (port of `repro.train.steps`:
cross_entropy, make_train_step, make_prefill, make_serve_step, and the
abstract inputs of the dry-run: input_specs, abstract_caches,
abstract_state).

Under a mesh (`rules` with a live `DeviceMesh`) the step takes the global
view: the state's leaves are DTensors placed by `state_specs`, the batch
is sharded over ("pod", "data"), and DTensor inserts the collectives
(the reference's GSPMD). Plain tensors made inside the step (positions,
masks, the vocab mask) are taken as replicated.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import obs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.collectives import compressed_pod_sync
from repro_torch.models import model as M
from repro_torch.optim.adamw import (OptimizerConfig, TrainState,
                                     adamw_init, adamw_update)
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def cross_entropy(logits, labels, vocab_size: int):
    """Mean CE over tokens in float32; the padded vocab tail is masked
    out."""
    # the gold logit is a gather along the vocab, which DTensor does not
    # shard through
    logits = _vocab_whole(logits.float())
    Vp = logits.shape[-1]
    if Vp != vocab_size:
        neg = torch.where(torch.arange(Vp, device=logits.device) < vocab_size,
                          0.0, -1e30)
        logits = logits + neg
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    return torch.mean(logz - gold)


def _vocab_whole(x):
    """A DTensor of logits with the vocab (last) dim whole on every rank
    and its partial sums complete; a plain tensor passes through."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() or p == Shard(x.ndim - 1) else p
        for p in x.placements])


def _mesh_context(tree):
    """Plain tensors mixed with DTensors count as replicated, where the
    tree holds DTensors."""
    if any(isinstance(t, DTensor) for t in tree_leaves(tree)):
        return implicit_replication()
    return contextlib.nullcontext()


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _placed_like(g, p):
    """A DTensor gradient in its parameter's placements (DTensor may leave
    it partial, or laid out otherwise)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_grad_fn(cfg: ModelConfig, rules=None, *, use_kernels=True,
                 remat=True, microbatches: int = 1):
    """grad_fn(params, batch) -> (metrics, grads): the loss's gradient with
    respect to every leaf of `params`, in the params' tree, dtypes and (for
    DTensors) placements (float32 when microbatches > 1). The metrics are
    plain tensors.

    batch: {"tokens", "labels"} (B, S) integer tensors, and "extra" for
    the cross-attention families (see `models.model.forward`).
    microbatches > 1: gradient accumulation over k sequential slices of
    the batch in a float32 accumulator, the mean of the k gradients.
    """
    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(live)
        with _mesh_context(leaves):
            with obs.span("train.forward"):
                logits, aux, _ = M.forward(live, cfg, batch["tokens"],
                                           extra=batch.get("extra"),
                                           rules=rules,
                                           use_kernels=use_kernels,
                                           remat=remat)
                ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
                loss = ce + aux
            # under remat the periods' recomputed forward runs in here
            with obs.span("train.backward", timed=True):
                grads = torch.autograd.grad(loss, leaves)
        grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
        return ({"loss": _full(ce.detach()), "aux": _full(aux.detach())},
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


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    rules=None, *, use_kernels=True, remat=True,
                    grad_sync: str = "gspmd", microbatches: int = 1):
    """Returns train_step(state, batch) -> (state, metrics); the state is
    updated in place (see `adamw_update`). `batch` holds full (B, S)
    tensors, the same on every rank.

    grad_sync: 'gspmd' (the collectives DTensor inserts; one device when
    `rules` is None) or 'compressed_pod' (Lovelock §6: the int8
    error-feedback all-reduce on the cross-pod hop, see
    core/collectives.py). Without a pod axis, or without `rules`,
    'compressed_pod' is 'gspmd', as in the reference.

    microbatches > 1: gradient accumulation (see `make_grad_fn`).
    """
    if grad_sync not in ("gspmd", "compressed_pod"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    lr_fn = cosine_schedule(opt_cfg.lr, opt_cfg.warmup, opt_cfg.total_steps)
    live = rules is not None and rules.live
    if grad_sync == "compressed_pod" and live and \
            "pod" in rules.desc.axis_names:
        # the reference's inner forward runs without activation constraints
        # (with_sharding_constraint inside its partial-manual shard_map trips
        # XLA); layouts follow the params'
        return _compressed_pod_step(
            rules.mesh, opt_cfg, lr_fn,
            make_grad_fn(cfg, None, use_kernels=use_kernels, remat=remat,
                         microbatches=microbatches))
    grad_fn = make_grad_fn(cfg, rules, use_kernels=use_kernels, remat=remat,
                           microbatches=microbatches)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with obs.span("train.step", step=state.step):
            if live:
                batch = rules.shard_batch(batch)
            metrics, grads = grad_fn(state.params, batch)
            with _mesh_context(grads), obs.span("train.optimizer",
                                                timed=True):
                state = adamw_update(state, grads, opt_cfg, lr_fn)
        return state, metrics
    return train_step


def _compressed_pod_step(mesh, opt_cfg, lr_fn, grad_fn):
    """Lovelock's compressed cross-pod sync. The state is replicated over
    pods (`state_specs(..., fsdp_pod=False)`) and carries `ef`. Each pod
    takes its slice of the batch and computes its gradients on its
    ("data", "model") sub-mesh; `compressed_pod_sync` means them over pods
    as int8 with error feedback; every pod then takes the same AdamW step,
    and the metrics are averaged over pods."""
    sub = mesh["data", "model"]
    pod = mesh.get_group("pod")
    npods = dist.get_world_size(pod)
    me = mesh.get_local_rank("pod")

    def on_sub(t):
        """A state leaf as a DTensor on the pod's sub-mesh, sharing the
        storage of its local shard."""
        if not isinstance(t, DTensor):
            return t
        if not isinstance(t.placements[0], Replicate) or \
                t.device_mesh.mesh_dim_names[0] != "pod":
            raise ValueError("grad_sync='compressed_pod' takes a state "
                             "replicated over 'pod': state_specs(..., "
                             "fsdp_pod=False)")
        return DTensor.from_local(t.to_local(), sub, t.placements[1:],
                                  shape=t.shape, stride=t.stride())

    def pod_rows(t):
        """This pod's rows of a full batch tensor, split over 'data'."""
        if t.shape[0] % npods:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split "
                             f"over {npods} pods")
        b = t.shape[0] // npods
        rows = t[me * b:(me + 1) * b]
        split = rows.shape[0] % sub.size(0) == 0
        return distribute_tensor(rows, sub, (Shard(0) if split
                                             else Replicate(), Replicate()),
                                 src_data_rank=None)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.ef is None:
            raise ValueError("grad_sync='compressed_pod' needs the state's "
                             "error feedback: adamw_init(..., with_ef=True)")
        local = TrainState(state.step, *(None if t is None else
                                         tree_map(on_sub, t)
                                         for t in state[1:]))
        metrics, grads = grad_fn(local.params, tree_map(pod_rows, batch))
        grads, new_ef = compressed_pod_sync(grads, local.ef, mesh)
        with _mesh_context(grads):
            tree_map(lambda e, n: e.copy_(n), local.ef, new_ef)
            local = adamw_update(local, grads, opt_cfg, lr_fn)
        for m in metrics.values():
            dist.all_reduce(m, group=pod)
            m.div_(npods)
        return state._replace(step=local.step), metrics
    return train_step


def make_prefill(cfg: ModelConfig, rules=None, *, use_kernels=True):
    def prefill(params, caches, batch):
        with _mesh_context(tree_leaves(params)):
            logits, _, caches = M.forward(
                params, cfg, batch["tokens"], extra=batch.get("extra"),
                rules=rules, caches=caches, use_kernels=use_kernels)
        return logits[:, -1:], caches
    return prefill


def make_serve_step(cfg: ModelConfig, rules=None, *, use_kernels=True):
    """serve_step(params, caches, token) -> (next_token, caches, logits).

    Greedy: the next token is the argmax over the real vocabulary (padded
    ids masked). `logits` (B, Vp) are the last position's, before the
    vocab mask; the reference returns only (next_token, caches).
    """
    def serve_step(params, caches, token):
        with _mesh_context(tree_leaves(params)):
            logits, caches = M.decode_step(params, cfg, token, caches,
                                           rules=rules,
                                           use_kernels=use_kernels)
            last = logits[:, -1]
            # argmax along a vocab split over "model" is not sharded
            # through either (a batch of one broke DTensor's gather)
            scores = _vocab_whole(last.float())
            Vp = scores.shape[-1]
            if Vp != cfg.vocab_size:
                pad = torch.arange(Vp, device=scores.device) >= \
                    cfg.vocab_size
                scores = scores.masked_fill(pad, -1e30)
            return scores.argmax(-1)[:, None], caches, last
    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs (dry-run / roofline)
# ---------------------------------------------------------------------------
# The reference's `jax.eval_shape` trees: FakeTensors made under a
# FakeTensorMode of their own, so nothing is allocated. Keys, shapes and
# dtypes are the reference's leaf for leaf.


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """FakeTensors for the *data* inputs of a step: tokens and labels
    (train), tokens (prefill), each with `extra` image embeddings or audio
    frames in the compute dtype for the cross-attention families; the
    decode `token` (B, 1)."""
    B, S = shape.global_batch, shape.seq_len
    dt = M._dtype(cfg.compute_dtype)
    with FakeTensorMode():
        if shape.kind == "decode":
            return {"token": torch.empty((B, 1), dtype=torch.int32)}
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32)}
        if shape.kind == "train":
            batch["labels"] = torch.empty((B, S), dtype=torch.int32)
        extra = {}
        if cfg.cross_attn_every:
            extra["image_embeds"] = torch.empty(
                (B, cfg.num_image_tokens, cfg.d_model), dtype=dt)
        if cfg.encoder_layers:
            extra["audio_frames"] = torch.empty(
                (B, cfg.num_audio_frames, cfg.d_model), dtype=dt)
        if extra:
            batch["extra"] = extra
        return batch


def abstract_caches(cfg: ModelConfig, shape: ShapeConfig, tp: int,
                    dtype=torch.bfloat16) -> dict:
    """The FakeTensor tree of `models.model.init_caches` (`index` an
    int)."""
    with FakeTensorMode():
        return M.init_caches(cfg, shape.global_batch, shape.seq_len, tp,
                             dtype, device="cpu")


def abstract_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, tp: int,
                   with_ef: bool = False) -> TrainState:
    """The FakeTensor tree of the full TrainState (`step` the int 0)."""
    with FakeTensorMode():
        params = M.init_params(torch.Generator().manual_seed(0), cfg, tp)
        return adamw_init(params, opt_cfg, with_ef=with_ef)
