"""Elastic scaling and straggler mitigation.

Elastic re-mesh: a checkpoint written on mesh A restores onto mesh B with
another data-parallel degree (a lost node, a scale-up). Checkpoints hold
full logical arrays (`repro_torch.checkpoint`, the JAX on-disk format) and
the shardings are recomputed from the *target* mesh's rules, so
`remesh_restore` is a restore that places each leaf by its new sharding;
`rescale_schedule` keeps the global batch through gradient accumulation.

`StragglerMonitor` tracks per-step durations and flags those past a deadline
of ``deadline_factor`` x the median; repeated strikes mark a host for
eviction. The serving scheduler feeds every tick's wall time into
`StragglerMonitor.observe`. `Heartbeat` is the liveness tracker a launcher
polls between steps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

PyTree = Any


def remesh_restore(ckpt, step: int, like: PyTree, new_mesh,
                   new_specs: PyTree) -> PyTree:
    """Restore ``step`` onto another mesh and sharding (elastic restart):
    each leaf a `ShardedTensor` placed by ``new_specs`` on ``new_mesh``."""
    from repro_torch.distributed.sharding import to_shardings

    return ckpt.restore(step, like,
                        shardings=to_shardings(new_specs, new_mesh))


def rescale_schedule(global_batch: int, old_hosts: int, new_hosts: int,
                     per_host_batch: int) -> dict:
    """Keep the global batch constant across an elastic resize via
    gradient accumulation."""
    new_per_step = new_hosts * per_host_batch
    accum = max(1, -(-global_batch // new_per_step))
    return {
        "grad_accum_steps": accum,
        "per_host_batch": per_host_batch,
        "effective_global_batch": accum * new_per_step,
    }


@dataclass
class StragglerMonitor:
    """Deadline-based straggler detection over per-host step heartbeats."""

    n_hosts: int
    deadline_factor: float = 2.0  # x median step time
    min_deadline_s: float = 1.0
    history: list[float] = field(default_factory=list)
    flagged: dict[int, int] = field(default_factory=dict)  # host -> strikes
    evict_after: int = 3
    #: optional telemetry feed — `(verdict, flagged) -> None`, called after
    #: every heartbeat. The serving tier points this at
    #: `repro_torch.obs.FlightRecorder.record_straggler`, so per-host strike
    #: counts and the current deadline surface as registry gauges.
    sink: Any = None

    def _publish(self, verdict: dict) -> None:
        if self.sink is not None:
            self.sink(verdict, dict(self.flagged))

    def step_times(self, times_s: dict[int, float]) -> dict:
        """Feed per-host durations for one step; returns the policy verdict."""
        med = sorted(times_s.values())[len(times_s) // 2]
        self.history.append(med)
        deadline = max(self.min_deadline_s, self.deadline_factor * med)
        slow = [h for h, t in times_s.items() if t > deadline]
        for h in slow:
            self.flagged[h] = self.flagged.get(h, 0) + 1
        for h in list(self.flagged):
            if h not in slow:
                self.flagged[h] = 0
        evict = [h for h, strikes in self.flagged.items()
                 if strikes >= self.evict_after]
        verdict = {
            "deadline_s": deadline,
            "stragglers": slow,
            "evict": evict,  # launcher responds with elastic re-mesh
            "skip_contribution": slow,  # bounded-staleness option
        }
        self._publish(verdict)
        return verdict

    def observe(self, host: int, dt_s: float, *, window: int = 64) -> dict:
        """Single-stream variant of `step_times`: one duration per call,
        compared against the rolling median of recent history instead of a
        same-step cross-host median (which is degenerate at n=1).

        This is the serving-tier heartbeat: the micro-batch scheduler feeds
        every tick's wall time here (`repro_torch.serve.scheduler`), so a tick
        that blows past ``deadline_factor`` x the recent median — a stuck
        collective, a device fallen off the mesh — accrues strikes, and
        ``evict`` firing is the control plane's cue to shed load. Same
        strike/decay/evict policy as `step_times`.
        """
        hist = self.history[-window:]
        baseline = sorted(hist)[len(hist) // 2] if hist else dt_s
        self.history.append(dt_s)
        deadline = max(self.min_deadline_s, self.deadline_factor * baseline)
        slow = [host] if dt_s > deadline else []
        for h in slow:
            self.flagged[h] = self.flagged.get(h, 0) + 1
        if not slow and self.flagged.get(host):
            self.flagged[host] = 0
        evict = [h for h, strikes in self.flagged.items()
                 if strikes >= self.evict_after]
        verdict = {
            "deadline_s": deadline,
            "stragglers": slow,
            "evict": evict,
            "skip_contribution": slow,
        }
        self._publish(verdict)
        return verdict


class Heartbeat:
    """Minimal liveness tracker the launcher polls between steps."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.last: dict[int, float] = {}

    def beat(self, host: int, now: float | None = None) -> None:
        self.last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.last.items() if now - t > self.timeout_s]
