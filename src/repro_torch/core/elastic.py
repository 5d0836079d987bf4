"""Elastic scaling, checkpoint/restart recovery, straggler mitigation
(port of `repro.core.elastic`).

Fault-tolerance contract (designed for 1000+ nodes, simulated here):

  * every K steps the coordinator streams a checkpoint (bounded memory,
    atomic commit — core/streaming_checkpoint.py);
  * on node failure the runner re-plans the mesh over the surviving
    ranks (model axis preserved, data axis shrunk to the largest
    divisor), re-builds shardings, and restores the last checkpoint into
    the placements of the live state;
  * stragglers: per-step host timings feed an EWMA; a host whose time
    exceeds `deadline_factor` x median for `patience` consecutive steps is
    declared persistent and evicted via the same elastic path (transient
    blips are just waited out — SPMD cannot drop a worker mid-step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import device_type


# ---------------------------------------------------------------------------
# Mesh re-planning
# ---------------------------------------------------------------------------


def plan_mesh_shape(n_devices: int, *, model: int = 16,
                    want_pods: int = 1) -> tuple:
    """Largest (pod, data, model) grid that fits n_devices.

    Keeps the model axis intact (re-sharding TP state is the expensive
    path) and shrinks data parallelism, dropping to 1 pod if needed.
    """
    if n_devices < model:
        # degenerate: shrink model axis to largest power of two that fits
        model = 2 ** int(math.log2(max(n_devices, 1)))
    per_pod = n_devices // max(want_pods, 1)
    data = max(1, per_pod // model)
    pods = want_pods if want_pods > 1 and n_devices >= 2 * model else 1
    if pods > 1:
        return (pods, data, model)
    data = max(1, n_devices // model)
    return (data, model)


def make_elastic_mesh(ranks: Sequence[int], *, model: int = 16) -> DeviceMesh:
    """A ("data", "model") mesh of `plan_mesh_shape(len(ranks))` over the
    first ranks of `ranks` (the survivors of the process group). Every rank
    of the process group must call it."""
    shape = plan_mesh_shape(len(ranks), model=model)
    names = (("pod", "data", "model") if len(shape) == 3
             else ("data", "model"))
    grid = torch.tensor(list(ranks)[:math.prod(shape)]).reshape(shape)
    return DeviceMesh(device_type(), grid, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# Failure / recovery timeline (simulator component)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FailureComponent:
    """Checkpoint/replay recovery timeline, mirroring ElasticRunner.

    On a node failure at training step ``s`` the cluster restores the last
    durable checkpoint (restore + mesh re-plan latency) and replays every
    step since it. `repro.sim.workloads.training_from_trace` expands this
    into explicit recovery + replay tasks on the event timeline.
    """

    ckpt_every: int = 10
    restore_s: float = 30.0
    replan_s: float = 5.0

    def lost_steps(self, fail_step: int) -> int:
        return fail_step - (fail_step // self.ckpt_every) * self.ckpt_every

    def recovery_delay(self) -> float:
        return self.restore_s + self.replan_s


# ---------------------------------------------------------------------------
# Straggler detection (coordinator-side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 2.0
    patience: int = 3
    ewma: float = 0.3


class StragglerDetector:
    def __init__(self, n_hosts: int, policy: StragglerPolicy = None):
        self.policy = policy or StragglerPolicy()
        self.est = np.zeros(n_hosts)
        self.strikes = np.zeros(n_hosts, dtype=int)
        self.active = np.ones(n_hosts, dtype=bool)

    def deactivate(self, host: int) -> None:
        """Drop an evicted host from the median and strike counting, so
        detection keeps working on the survivors."""
        self.active[host] = False
        self.strikes[host] = 0

    def observe(self, step_times: Sequence[float]) -> list[int]:
        """Feed per-host times for one step; returns hosts to evict.
        Entries for deactivated hosts (or NaN placeholders) are ignored.
        """
        t = np.asarray(step_times, dtype=float)
        a = self.policy.ewma
        upd = self.active & np.isfinite(t)
        est = np.where(self.est == 0, t, a * t + (1 - a) * self.est)
        self.est = np.where(upd, est, self.est)
        if not upd.any():
            return []
        # median over hosts that have actually reported: the 0-valued
        # est sentinel of a never-measured host must not drag the
        # median to 0 and flag every real measurement as slow
        live = self.active & (self.est > 0)
        med = float(np.median(self.est[live]))
        slow = upd & (self.est > self.policy.deadline_factor * med)
        # a host with no measurement this step keeps its strikes (ignored,
        # not absolved); a measured-fast host resets to 0
        self.strikes = np.where(slow, self.strikes + 1,
                                np.where(upd, 0, self.strikes))
        return list(np.nonzero(self.strikes >= self.policy.patience)[0])


# ---------------------------------------------------------------------------
# Elastic training runner (simulated failures; real checkpoint/restore)
# ---------------------------------------------------------------------------


class ElasticRunner:
    """Drives train steps with periodic streaming checkpoints and recovers
    from injected failures by re-planning the step and restoring the last
    checkpoint."""

    def __init__(self, *, make_step: Callable, init_state, checkpointer,
                 ckpt_every: int = 10):
        self.make_step = make_step          # (mesh) -> step fn
        self.state = init_state
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.recoveries = 0
        self.steps_done = 0

    def run(self, batches, *, fail_at: Optional[dict] = None):
        """batches: step-indexed list (the data pipeline is deterministic
        in step, so replayed steps re-fetch identical data).
        fail_at: {step: n_devices_lost} — simulated failure injection.

        The step updates the state in place (`adamw_update`), so a restore
        allocates a fresh state in the live state's placements."""
        fail_at = dict(fail_at or {})
        step_fn = self.make_step(None)
        total = len(batches)
        while self.state.step < total:
            step = self.state.step
            if step in fail_at:
                # --- failure: recover from last durable checkpoint ---
                del fail_at[step]
                self.recoveries += 1
                self.state = self.ckpt.restore(self.state,
                                               step=self.ckpt.latest_step())
                step_fn = self.make_step(None)   # re-plan
                continue
            self.state, _metrics = step_fn(self.state, batches[step])
            self.steps_done += 1
            if self.state.step % self.ckpt_every == 0:
                self.ckpt.save(self.state.step, self.state)
        return self.state
