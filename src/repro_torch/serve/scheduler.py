"""Continuous micro-batching scheduler for the multi-tenant ACAM service.

Requests from *any* tenant are coalesced into fixed-slot micro-batches and
served by ONE matching call per tick:

    tick:  pop <= slots requests (FIFO across tenants)
           -> one `MatchEngine.classify_serve` call over the registry's
              super-bank: the per-slot tenant threshold-row gather,
              binarisation, match, per-slot class-window Eq. 12 decision +
              margin and the cascade's ``margin < tau`` bit — on the kernel
              backend one `acam_match_serve` kernel call
           -> per-slot tenant-local predictions + margins + escalate bits

The batch shape is pinned to ``slots``: ragged tails are padded with empty
class windows (pred 0 / margin 0, dropped here) and tau = -inf (never
escalate). Every tick's wall time heartbeats into a `StragglerMonitor`;
`expire()` pops requests past the cascade's per-request deadline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch import match as match_lib
from repro_torch.ft.elastic import StragglerMonitor
from repro_torch.serve.registry import TemplateBankRegistry, TenantEntry


@dataclasses.dataclass
class WorkItem:
    """One admitted classification request, as the scheduler sees it. Holds
    only the tenant *id*: the placement is resolved at tick time."""

    request_id: int
    tenant_id: str
    features: np.ndarray  # (N,) float32, raw front-end features
    submit_t: float


@dataclasses.dataclass
class SlotResult:
    """Scheduler output for one served request."""

    item: WorkItem
    entry: TenantEntry | None  # placement at dispatch time; None on error
    pred_local: int  # tenant-local class id (global - tenant offset)
    margin: float  # Eq. 12 winner-vs-runner-up confidence margin
    error: str | None = None  # e.g. tenant evicted while queued
    escalate: bool = False  # in-kernel margin < tau(tenant) cascade bit
    #: winner's absolute per-class score (match count 0..N)
    score: float = 0.0


@dataclasses.dataclass
class SchedulerStats:
    slots: int = 0
    ticks: int = 0
    classify_dispatches: int = 0
    served: int = 0
    filled_slots: int = 0
    min_fill: int | None = None
    max_fill: int = 0
    tick_time_s: float = 0.0  # summed dispatch wall time
    slow_ticks: int = 0  # ticks flagged by the straggler monitor
    expired: int = 0  # requests expired past their queue deadline

    def record_tick(self, fill: int, *, dt_s: float = 0.0,
                    slow: bool = False) -> None:
        self.ticks += 1
        self.classify_dispatches += 1
        self.served += fill
        self.filled_slots += fill
        self.max_fill = max(self.max_fill, fill)
        self.min_fill = fill if self.min_fill is None else \
            min(self.min_fill, fill)
        self.tick_time_s += dt_s
        self.slow_ticks += int(slow)

    @property
    def occupancy(self) -> float:
        """Mean batch fill fraction across ticks (1.0 = every slot used)."""
        if self.ticks == 0:
            return 0.0
        return self.filled_slots / (self.ticks * self.slots)

    def as_dict(self) -> dict:
        return {
            "ticks": self.ticks,
            "classify_dispatches": self.classify_dispatches,
            "served": self.served,
            "occupancy": round(self.occupancy, 4),
            "min_fill": self.min_fill or 0,
            "max_fill": self.max_fill,
            "slots": self.slots,
            "tick_time_s": round(self.tick_time_s, 6),
            "slow_ticks": self.slow_ticks,
            "expired": self.expired,
        }


class MicroBatchScheduler:
    """Fixed-slot continuous micro-batching over a `TemplateBankRegistry`,
    matching under ONE `EngineConfig` (the spec's, passed through)."""

    def __init__(self, registry: TemplateBankRegistry, *, slots: int = 64,
                 engine: match_lib.EngineConfig = match_lib.EngineConfig(
                     margin=True),
                 monitor: StragglerMonitor | None = None, recorder=None):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.registry = registry
        self.slots = slots
        self.engine_config = engine
        self.stats = SchedulerStats(slots=slots)
        self.monitor = monitor if monitor is not None else StragglerMonitor(
            n_hosts=1)
        self.last_verdict: dict | None = None
        #: optional `repro_torch.obs.FlightRecorder`: stamps dispatched
        #: spans and feeds the scheduler counters
        self.recorder = recorder
        #: optional tenant_id -> margin threshold (None = no head: never
        #: escalate); feeds the per-slot ``tau`` operand of the serve kernel
        self.tau_fn = None
        self._queue: deque[WorkItem] = deque()

    @property
    def method(self) -> str:
        return self.engine_config.method

    @property
    def alpha(self) -> float:
        return self.engine_config.alpha

    def set_engine(self, engine: match_lib.EngineConfig) -> None:
        """Live engine swap (the control plane's engine transition): the
        next tick dispatches under the new config."""
        self.engine_config = engine

    @property
    def qsize(self) -> int:
        return len(self._queue)

    def submit(self, item: WorkItem) -> None:
        self._queue.append(item)

    def expire(self, deadline_s: float,
               now: float | None = None) -> list[WorkItem]:
        """Pop queued items older than ``deadline_s`` (a FIFO prefix)."""
        now = time.perf_counter() if now is None else now
        out: list[WorkItem] = []
        while self._queue and now - self._queue[0].submit_t > deadline_s:
            out.append(self._queue.popleft())
        self.stats.expired += len(out)
        if out and self.recorder is not None:
            self.recorder.record_expired(len(out))
        return out

    def tick(self) -> list[SlotResult]:
        """Serve one micro-batch; returns [] when the queue is empty."""
        if not self._queue:
            return []
        t0 = time.perf_counter()
        popped = [self._queue.popleft()
                  for _ in range(min(self.slots, len(self._queue)))]
        dead = []
        batch: list[tuple[WorkItem, TenantEntry]] = []
        for item in popped:
            entry = self.registry.lookup(item.tenant_id)
            if entry is None:
                dead.append(SlotResult(
                    item=item, entry=None, pred_local=-1, margin=0.0,
                    error=f"tenant {item.tenant_id!r} evicted while queued"))
            else:
                batch.append((item, entry))
        if not batch:
            return dead
        n = self.registry.num_features

        feats = np.zeros((self.slots, n), np.float32)
        slot_idx = np.zeros((self.slots,), np.int32)
        lo = np.zeros((self.slots,), np.int32)
        hi = np.zeros((self.slots,), np.int32)  # padding: empty window [0, 0)
        tau = np.full((self.slots,), -np.inf, np.float32)  # never escalate
        for i, (item, entry) in enumerate(batch):
            feats[i] = item.features
            slot_idx[i] = entry.slot
            lo[i], hi[i] = entry.window
            if self.tau_fn is not None:
                t = self.tau_fn(item.tenant_id)
                if t is not None:
                    tau[i] = t

        eng = match_lib.engine_from_config(self.engine_config)
        dev = self.registry.device
        annotate = self.recorder.profile_span("acam_fused_dispatch") \
            if self.recorder is not None else contextlib.nullcontext()
        with annotate:
            pred, per_class, margin, esc = eng.classify_serve(
                torch.from_numpy(feats).to(dev),
                self.registry.thresholds_table(),
                torch.from_numpy(slot_idx).to(dev),
                self.registry.device_bank(),
                torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
                torch.from_numpy(tau).to(dev))
            pred = pred.cpu().numpy()
            per_class = per_class.cpu().numpy()  # (slots, C_cap)
            margin = margin.cpu().numpy()
            esc = esc.cpu().numpy()
        dt = time.perf_counter() - t0
        self.last_verdict = self.monitor.observe(0, dt)
        slow = bool(self.last_verdict["stragglers"])
        self.stats.record_tick(len(batch), dt_s=dt, slow=slow)
        if self.recorder is not None:
            self.recorder.record_tick_dispatch(
                [item.request_id for item in popped], len(batch), dt, slow,
                t0)

        # winner's absolute score; an empty window's is -inf -> 0.0
        score = per_class[np.arange(len(batch)), pred[:len(batch)]]
        score = np.where(np.isfinite(score), score, 0.0)
        return dead + [
            SlotResult(item=item, entry=entry,
                       pred_local=int(pred[i]) - entry.offset,
                       margin=float(margin[i]), escalate=bool(esc[i]),
                       score=float(score[i]))
            for i, (item, entry) in enumerate(batch)]

    def drain(self) -> list[SlotResult]:
        out: list[SlotResult] = []
        while self._queue:
            out.extend(self.tick())
        return out
