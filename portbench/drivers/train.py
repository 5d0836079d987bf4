"""Training cells: the program's train step
(`repro_torch.train.steps.make_train_step`: no mesh, remat on, the
kernels on) over AdamW state made from the benchmark's weights, fed the
cell's zipf_markov batches.

Set-up builds the step and its state once and drives them through the
cell's first steps, on distinct batches, reading what the comparison
needs as it goes: each step's loss, each leaf's first gradient (from
the first moment after one step, m / (1 - b1)) and each leaf's change
after the first steps, of the float32 master and of the working weights
the model runs on, against the starting weights. The state's step
counter starts at the traffic's `start_step` (the end of the warmup),
where the learning rate moves the bf16 working weights. The same state
and step then run the window. Once the window has closed and the state
is freed, the float32 reference takes the same first steps from the
same weights (`reference.train_readings`).
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import generate


def first_steps(cell, params, batches):
    """(state, step, readings) after `len(batches)` steps of the program."""
    from repro_torch.optim.adamw import OptimizerConfig, adamw_init
    from repro_torch.train import steps
    ref, m = cell.reference, cell.model
    opt_cfg = OptimizerConfig(**cell.traffic["optimizer"])
    state = adamw_init(params, opt_cfg)._replace(
        step=cell.traffic.get("start_step", 0))
    step = steps.make_train_step(cell.model_config(), opt_cfg,
                                 use_kernels=True, remat=True)
    start = {n: t.clone() for n, t in ref.named_slices(params, m)}
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        state, met = step(state, batch)
        losses.append(met["loss"])
        if i == 0:
            grad = {n: float(t.float().norm()) / (1 - opt_cfg.b1)
                    for n, t in ref.named_slices(state.m, m)}
    def change(tree):
        return {n: float((t.float() - start[n].float()).norm())
                for n, t in ref.named_slices(tree, m)}
    final = state.master if state.master is not None else state.params
    readings = {"loss": [float(x) for x in losses], "grad": grad,
                "change": change(final), "param_change": change(state.params)}
    del start
    return state, step, readings


def reference_readings(cell, params, batches, quant=None) -> dict:
    """The reference's readings over the same first steps, from the same
    step counter."""
    tr = cell.traffic
    return cell.reference.train_readings(params, cell.model, batches,
                                         tr["optimizer"], quant=quant,
                                         start_step=tr.get("start_step", 0))


def compare(prog: dict, refr: dict, loss_steps=None) -> dict:
    """The numbers compared: the loss of each of the first `loss_steps`
    steps (all, by default; the largest gap, relative),
    each leaf's first-gradient norm and each leaf's change norm, of the
    master and of the working weights (the worst leaf's gap, over the
    larger of its reference norm and the median leaf's). A leaf whose
    reference gradient is under a thousandth of the median leaf's moves
    by round-off alone under Adam and is left out of the changes."""
    loss = max(abs(a - b) / abs(b) for a, b in
               list(zip(prog["loss"], refr["loss"]))[:loss_steps])

    def worst(p, r, names):
        med = float(np.median([r[n] for n in names]))
        return max(abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in names)
    gmed = float(np.median(list(refr["grad"].values())))
    moved = [n for n in refr["grad"] if refr["grad"][n] >= 1e-3 * gmed]
    return {"loss": loss,
            "grad_norm": worst(prog["grad"], refr["grad"], list(refr["grad"])),
            "change_norm": worst(prog["change"], refr["change"], moved),
            "param_change": worst(prog["param_change"], refr["param_change"],
                                  moved)}


def run(cell, window) -> dict:
    ref, m, tr, dev = cell.reference, cell.model, cell.traffic, cell.device
    params = ref.make_params(m, cell.seed, dev)
    batches = generate.train_batches(tr, m["vocab_size"], cell.seed, dev)
    first = tr["first_steps"]
    state, step, prog = first_steps(cell, params, batches[:first])
    B, S = tr["batch"], tr["seq_len"]
    losses, step_s = [], []
    with window.open():
        t = window.t0
        while True:
            with window.annotate("train_step"):
                state, met = step(state,
                                  batches[(first + len(losses)) % len(batches)])
            losses.append(met["loss"])
            now = window.clock()
            step_s.append(now - t)
            t = now
            if now - window.t0 >= cell.seconds:
                break
    n, elapsed = len(losses), window.elapsed
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = int(sum(not torch.isfinite(x).item() for x in losses))
    del state, step, params, met, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refr = reference_readings(cell, ref.make_params(m, cell.seed, dev),
                              batches[:first])
    return {"attempted": n, "failed": failed, "window_s": elapsed,
            "e2e": {"train_tokens_per_s": n * B * S / elapsed},
            "work": {"kind": "train", "steps": n, "batch": B, "seq_len": S},
            "series": {"step_s": step_s},
            "numbers": compare(prog, refr, tr.get("loss_steps")),
            "memory_peak_bytes": peak}
