"""Logical-axis sharding rules -> spec trees and DTensor placements (port
of `repro.sharding.rules`).

One rule table covers every architecture: weights are matched by their
key path in the param tree; activations by short logical names used in
model code via `rules.cs(x, name)`.

Mesh axes: ("pod",) "data", "model". Batch/FSDP ride ('pod','data');
tensor/expert parallelism rides 'model'. For batch=1 long-context decode,
`seq_sharded=True` moves the batch axes onto the sequence dim of the KV
cache instead.

A spec is a `Spec`: a tuple with one entry per tensor dim, each None, a
mesh-axis name or a tuple of names, as the reference's `PartitionSpec`.
Specs need only the mesh's axis names and sizes (`MeshDesc`), so they can
be computed for the production meshes without their ranks;
`to_placements` turns one into DTensor placements on a live
`DeviceMesh`.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.launch.mesh import describe
from repro_torch.tree import tree_map

Pytree = Any


class Spec(tuple):
    """One entry per tensor dim: None, a mesh-axis name, or a tuple of
    names (the dim split over those axes, the first one major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


P = Spec

# (regex on 'path', spec builder taking the batch axes 'b') — first match
# wins. Paths look like "layers/0/attn/wq"; stacked layer leaves have a
# leading n_periods dim (prepend None).
_W = [
    # embeddings
    (r"(embed|lm_head)$",             lambda b: P("model", b)),
    # attention / rwkv projections (D, H, hd) and (H, hd, D)
    (r"(attn|xattn|time_mix)/w[qkvrg]$", lambda b: P(b, "model", None)),
    (r"(attn|xattn|time_mix)/wo$",    lambda b: P("model", None, b)),
    (r"(attn|xattn)/(qn|kn)$",        lambda b: P(None)),
    (r"(attn|xattn)/gate$",           lambda b: P()),
    # MoE
    (r"moe/router$",                  lambda b: P(b, None)),
    (r"moe/(w_gate|w_up)$",           lambda b: P("model", b, None)),
    (r"moe/w_down$",                  lambda b: P("model", None, b)),
    (r"moe/shared/(w_gate|w_up)$",    lambda b: P(b, "model")),
    (r"moe/shared/w_down$",           lambda b: P("model", b)),
    # dense FFN
    (r"(ffn|channel_mix)/(w_gate|w_up|wk)$", lambda b: P(b, "model")),
    (r"(ffn|channel_mix)/(w_down|wv)$", lambda b: P("model", b)),
    (r"channel_mix/wr$",              lambda b: P(b, "model")),
    # mamba
    (r"mamba/in_proj$",               lambda b: P(b, "model")),
    (r"mamba/conv_w$",                lambda b: P(None, "model")),
    (r"mamba/(conv_b|dt_bias|Dskip)$", lambda b: P("model")),
    (r"mamba/x_proj$",                lambda b: P("model", None)),
    (r"mamba/dt_proj$",               lambda b: P(None, "model")),
    (r"mamba/A_log$",                 lambda b: P("model", None)),
    (r"mamba/out_proj$",              lambda b: P("model", b)),
    # rwkv small tensors
    (r"time_mix/w_lora/a$",           lambda b: P(b, None)),
    (r"time_mix/w_lora/b$",           lambda b: P(None, b)),
    (r"time_mix/u$",                  lambda b: P("model", None)),
    # everything else (norm scales, mus, w0, ln_x, ...): shard the feature
    # dim over FSDP when it divides (the fixer below falls back to
    # replicated for small/odd dims — e.g. smoke configs)
    (r".*",                           lambda b: P(b)),
]


def _path_str(path: tuple) -> str:
    return "/".join(path)


def _map_with_path(fn, tree, prefix=()):
    """fn(path, leaf) over the leaves of a dict / list tree (an int leaf,
    such as a cache's `index`, included); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return fn(_path_str(prefix), tree)


def _axis_size(sizes: dict, ax) -> int:
    return math.prod(sizes[a] for a in
                     (ax if isinstance(ax, tuple) else ((ax,) if ax else ())))


def _fit(spec, shape, sizes: dict) -> Spec:
    """`spec` with the axes that do not divide their dim dropped (batch 1,
    tiny head counts in smoke configs)."""
    return P(*(ax if dim % _axis_size(sizes, ax) == 0 else None
               for dim, ax in zip(shape, spec)))


def _shape(leaf) -> tuple:
    return () if isinstance(leaf, int) else tuple(leaf.shape)


def param_specs(params: Pytree, mesh, *, stacked_prefix="layers/",
                fsdp_pod: bool = True, fsdp: bool = True) -> Pytree:
    """Spec tree for a param (or optimizer-state) tree; `mesh` a
    `DeviceMesh` or a `MeshDesc`.

    fsdp=False replicates params over the batch axes (TP-only sharding) —
    right for decode, where per-step FSDP all-gathers dominate collectives.
    """
    d = describe(mesh)
    cand = (("pod", "data") if fsdp_pod else ("data",)) if fsdp else ()
    b = tuple(n for n in cand if n in d.axis_names)
    b = b if len(b) > 1 else (b[0] if b else None)

    def spec_for(s, leaf):
        shape = _shape(leaf)
        spec = next(fn(b) for pat, fn in _W if re.search(pat, s))
        # stacked layer leaves carry a leading n_periods dim
        if s.startswith(stacked_prefix) or "/layers/" in s:
            spec = P(None, *spec)
        spec = P(*(tuple(spec[:len(shape)])
                   + (None,) * (len(shape) - len(spec))))
        return _fit(spec, shape, d.shape)

    return _map_with_path(spec_for, params)


def state_specs(state, mesh, *, fsdp_pod: bool = True) -> Any:
    """Spec tree for a TrainState (params/m/v/master/ef); `step` gets P().

    int8 moment leaves are {"q": like-param, "scale": like-param[:-1]}.
    """
    pspecs = param_specs(state.params, mesh, fsdp_pod=fsdp_pod)

    def moment_spec(leaf, ps):
        if isinstance(leaf, dict):      # int8 {"q","scale"}
            return {"q": ps, "scale": P(*ps[:-1])}
        return ps

    def like_params(tree):
        if tree is None:
            return None
        return tree_map(lambda p, t, ps: moment_spec(t, ps), state.params,
                        tree, pspecs)

    return type(state)(
        step=P(),
        params=pspecs,
        m=like_params(state.m),
        v=like_params(state.v),
        master=like_params(state.master),
        ef=like_params(state.ef),
    )


def to_placements(spec, mesh) -> tuple:
    """DTensor placements on `mesh` (a `DeviceMesh`) for `spec`: Shard(i)
    on each mesh dim that names tensor dim i, Replicate on the others."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, ax in enumerate(spec) if ax == name
                or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def tp_only(w):
    """A DTensor weight gathered over the batch axes, its "model" sharding
    kept: FSDP's all-gather before a use that DTensor does not shard
    through (norm scales, the embedding lookup, the unembedding). A plain
    tensor passes through."""
    if not isinstance(w, DTensor):
        return w
    placements = tuple(
        p if name == "model" else Replicate()
        for name, p in zip(w.device_mesh.mesh_dim_names, w.placements))
    if tuple(w.placements) == placements:
        return w
    return w.redistribute(w.device_mesh, placements)


def residual_carry(x, rules=None):
    """The residual stream after a sublayer, as the next sublayer takes it
    and its gradient as this one takes it back: in the table's layout for
    "act_bsd" under `rules`, else with pending partial sums reduced
    (Replicate where it was Partial), both ways; a plain tensor passes
    through. Another activation whose partial sums must not travel on
    (Mamba's x_proj output) takes the same treatment.

    The reference's scan carries the residual in the embedding's layout.
    Left to itself, DTensor carries the partial sums of a sublayer's last
    projection into the next sublayer (and the partial gradients of a
    sublayer's first projections back into the previous one), whose
    matmuls then gather their weights over "model", less to send than
    the activations, and every rank computes every rank's share."""
    if not isinstance(x, DTensor):
        return x
    if rules is not None:
        x = rules.cs(x, "act_bsd")
    elif any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    # from_local's backward brings the gradient to these placements
    return DTensor.from_local(x.to_local(grad_placements=x.placements),
                              x.device_mesh, x.placements, shape=x.shape,
                              stride=x.stride())


def vocab_parallel_embedding(table, tokens):
    """`F.embedding(tokens, table)`, vocab-parallel where `table` is a
    DTensor whose rows are split over "model", as the reference's lookup
    shards: the table is gathered over the batch axes only (`tp_only`),
    each rank looks up the ids its rows hold (zeros for the others), and
    one all-reduce over "model" sums the ranks' rows. The tokens keep
    their placements over the batch axes (a plain tensor counts as
    replicated). Other tables take the plain lookup.

    DTensor's own sharding of this lookup leaves a masked partial sum
    whose gradient torch 2.11 cannot take back ("Redistribution from one
    partial type (P(sum)) to another (MaskP(...)) is unsupported"); this
    one makes none: the partial sum is a plain one, reduced at once."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    w = tp_only(table)
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    if "model" not in names or w.placements[names.index("model")] != \
            Shard(0):
        return F.embedding(tokens, w)
    mi = names.index("model")
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    tp = [Replicate() if i == mi else p
          for i, p in enumerate(tokens.placements)]
    if tuple(tp) != tuple(tokens.placements):
        tokens = tokens.redistribute(mesh, tp)
    rows = w.shape[0] // mesh.size(mi)      # the split divides (`_fit`)
    ids = tokens.to_local() - mesh.get_local_rank(mi) * rows
    hit = (ids >= 0) & (ids < rows)
    # the local rows' gradient: a partial sum over the axes that split
    # the tokens
    grad = [Shard(0) if i == mi else Partial() if p.is_shard() else
            Replicate() for i, p in enumerate(tp)]
    x = F.embedding(ids.clamp(0, rows - 1), w.to_local(grad_placements=grad))
    x = torch.where(hit[..., None], x, 0)
    shape = (*tokens.shape, w.shape[1])
    x = DTensor.from_local(
        x, mesh, [Partial() if i == mi else p for i, p in enumerate(tp)],
        shape=shape, stride=torch.empty(shape, device="meta").stride())
    return x.redistribute(mesh, tp)


def place(tree, specs, mesh):
    """Every tensor leaf of `tree` as a DTensor on `mesh` in its spec's
    placements (int leaves stay). Each rank must hold the same full
    tensors: each keeps its own shard, with no communication."""
    def one(t, spec):
        if isinstance(t, int):
            return t
        return distribute_tensor(t.detach(), mesh, to_placements(spec, mesh),
                                 src_data_rank=None)
    return tree_map(one, tree, specs)


def gather(tree):
    """Every DTensor leaf of `tree` as its full tensor (a collective)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


class ShardingRules:
    """Activation constraints + input/cache/param specs for one run; `mesh`
    a `DeviceMesh` (a live run) or a `MeshDesc` (specs only)."""

    def __init__(self, mesh, *, seq_sharded: bool = False, batch: int = 0,
                 exclude_pod: bool = False):
        self.mesh = mesh
        d = self.desc = describe(mesh)
        cand = ("data",) if exclude_pod else ("pod", "data")
        bd = tuple(n for n in cand if n in d.axis_names)
        self.batch_axes = bd if len(bd) > 1 else (bd[0] if bd else None)
        self.seq_sharded = seq_sharded
        ba = self.batch_axes
        if seq_sharded:     # batch=1 long-context: seq carries the DP axes
            B, S = None, ba
        else:
            B, S = ba, None
        self.table = {
            "act_bsd":   P(B, S, None),
            "act_bshd":  P(B, S, "model", None),
            "act_bsf":   P(B, S, "model"),
            "logits_bsv": P(B, S, "model"),
            "moe_ecd":   P("model", None, None),
            "moe_ecf":   P("model", None, None),
            "tokens":    P(B, S),
        }

    @property
    def live(self) -> bool:
        return isinstance(self.mesh, DeviceMesh)

    def spec(self, name: str, shape) -> Spec:
        """The table's spec for `name`, fitted to `shape`."""
        return _fit(self.table[name], shape, self.desc.shape)

    def cs(self, x, name: str):
        """`x` redistributed to the table's placements for `name` (the axes
        that do not divide dropped); `x` itself when it is not a DTensor on
        a live mesh."""
        if not (self.live and isinstance(x, DTensor)):
            return x
        placements = to_placements(self.spec(name, x.shape), self.mesh)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(self.mesh, placements)

    # ---- input / cache specs ----

    def batch_sharding(self) -> Spec:
        return self.table["tokens"]

    def shard_batch(self, batch: dict) -> dict:
        """A batch of full (B, S) tensors, the same on every rank, as
        DTensors in the tokens' placements (extras by their batch dim)."""
        def one(t):
            if isinstance(t, DTensor):
                return t
            spec = self.spec("tokens", t.shape[:2])
            return distribute_tensor(t, self.mesh,
                                     to_placements(spec, self.mesh),
                                     src_data_rank=None)
        return tree_map(one, batch)

    def cache_specs(self, caches: Pytree) -> Pytree:
        B, S = ((None, self.batch_axes) if self.seq_sharded
                else (self.batch_axes, None))

        def spec_for(s, leaf):
            shape = _shape(leaf)
            if not shape:
                return P()
            if s.endswith("/k") or s.endswith("/v"):
                # (n_periods, B, W, Kp, hd)
                spec = P(None, B, S, "model", None)
            elif "mamba/conv" in s:
                spec = P(None, B, None, "model")
            elif "mamba/ssm" in s:
                spec = P(None, B, "model", None)
            elif "tm/wkv" in s:
                spec = P(None, B, "model", None, None)
            elif s.endswith("shift") or s.endswith("cm"):
                spec = P(None, B, None, None)
            else:
                spec = P(*([None] * len(shape)))
            return _fit(spec[:len(shape)], shape, self.desc.shape)

        return _map_with_path(spec_for, caches)
