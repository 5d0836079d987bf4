"""Straggler detection (port of `repro.core.elastic`: StragglerPolicy and
StragglerDetector, numpy only).

Per-step host timings feed an EWMA; a host whose time exceeds
`deadline_factor` x the median for `patience` consecutive steps is
reported for eviction. The rest of the reference module (elastic meshes,
ElasticRunner) is ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


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
