"""AdamW with optional per-row int8 moments (port of `repro.optim.adamw`).

Memory policy, as in the reference:
  state_dtype = 'float32'  -- float32 m / v (+ a float32 master copy when
                              `master`)
  state_dtype = 'int8'     -- per-row int8 m / v with float32 scales, no
                              master (the params themselves)

Written by hand, not as `torch.optim.AdamW`, to keep the reference's order
of operations: global-norm clip in float32, bias corrections in float32,
decay applied to the float32 master, `new_p = master.to(p.dtype)`. Unlike
the reference, which returns a new state, `adamw_update` writes params,
moments and master in place: at full width a second copy of the state does
not fit next to the first. Under a mesh the leaves are DTensors, and the
same code runs on them (DTensor reduces the global-norm sum across
shards).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"      # 'float32' | 'int8'
    master: bool = True               # float32 master copy (float32 mode)
    warmup: int = 100
    total_steps: int = 10_000


class TrainState(NamedTuple):
    """The reference's TrainState; `step` is an int. `ef` is the error
    feedback of the compressed cross-pod sync (bf16, like the params), or
    None."""
    step: int
    params: dict
    m: dict
    v: dict
    master: Optional[dict]
    ef: Optional[dict] = None


# ---- per-row int8 quantization ---------------------------------------------


def _quant(x):
    """Per-row (last-axis) int8 quantization; round half to even, as
    jnp.round."""
    scale = x.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return {"q": q, "scale": scale.squeeze(-1).float()}


def _dequant(d):
    return d["q"].float() * d["scale"][..., None]


def _zeros_like_state(p, dtype):
    if dtype == "int8":     # what _quant gives for zeros
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                     device=p.device)}
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: dict, cfg: OptimizerConfig, *,
               with_ef: bool = False) -> TrainState:
    m = tree_map(lambda p: _zeros_like_state(p, cfg.state_dtype), params)
    v = tree_map(lambda p: _zeros_like_state(p, cfg.state_dtype), params)
    master = None
    if cfg.state_dtype == "float32" and cfg.master:
        master = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                        device=p.device),
                  params) if with_ef else None
    return TrainState(0, params, m, v, master, ef)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@torch.no_grad()
def adamw_update(state: TrainState, grads: dict, cfg: OptimizerConfig,
                 lr_fn: Callable) -> TrainState:
    """One AdamW step; updates the state's tensors in place and returns
    the state with the step advanced (`ef` carried through unchanged)."""
    step = state.step + 1
    lr = lr_fn(step)
    # global-norm clip, summed over the leaves in jax.tree.leaves order
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    bc1 = float(1 - _f32(cfg.b1) ** _f32(step))
    bc2 = float(1 - _f32(cfg.b2) ** _f32(step))
    int8 = cfg.state_dtype == "int8"

    def upd(p, g, m, v, mast=None):
        g = g.float() * scale
        m_f = _dequant(m) if int8 else m
        v_f = _dequant(v) if int8 else v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
        u = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        base = mast if mast is not None else p.float()
        new_master = base - lr * (u + cfg.weight_decay * base)
        p.copy_(new_master)
        if mast is not None:
            mast.copy_(new_master)
        for old, new in ((m, m_f), (v, v_f)):
            if int8:
                for name, t in _quant(new).items():
                    old[name].copy_(t)
            else:
                old.copy_(new)

    if state.master is not None:
        tree_map(upd, state.params, grads, state.m, state.v, state.master)
    else:
        tree_map(upd, state.params, grads, state.m, state.v)
    return state._replace(step=step)
