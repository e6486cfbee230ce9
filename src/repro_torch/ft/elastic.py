"""Straggler detection over step / tick heartbeats.

`StragglerMonitor` tracks per-step durations and flags those past a deadline
of ``deadline_factor`` x the median; repeated strikes mark a host for
eviction. The serving scheduler feeds every tick's wall time into
`StragglerMonitor.observe`. (Elastic re-mesh across cards comes with the
multi-GPU slice of the port.)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


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
