"""Per-request span tracing: admission -> queue -> tick -> dispatch ->
cascade -> response, with wall-clock stamps and the serving tick id.

A `Span` is the request's flight record: when it was admitted, when its
tick dequeued it, how long the fused dispatch took, what the cascade
decided, and how it left the service (`disposition`). The derived views
(`queue_ms`, `service_ms`, `total_ms`) attribute a slow request to
queueing vs dispatch vs CNN escalation without guessing.

`SpanRecorder` enforces conservation: a span is opened exactly once at
admission (`start`) and removed exactly once at finalization (`finish`
pops it) — shed, deadline-expired, escalated, and errored requests all
travel the same open/close path, so finished-span count == finished
request count by construction, never by sampling luck.

Sampling (`ObsSpec.span_sample < 1.0`) is deterministic in the request
id — a Knuth-hash coin, no RNG state — so the same trace replayed twice
keeps the same spans and bit-identical serving results.

`span(name)` is the other kind: a named range inside a call of the port
(`HybridClassifier.predict`, the engine, the kernels' bank re-layout, the
trainer's step) for a `torch.profiler` trace. It records only while a
profiler is recording, as a `record_function` range that lands beside
the profiler's device events on the same clock; otherwise it is one
shared null context. The module imports the standard library alone: it looks
`torch` up among the loaded modules, so every layer can import it.
"""
from __future__ import annotations

import contextlib
import sys
import time
from collections import deque
from dataclasses import dataclass, field

#: terminal dispositions a request can leave the service with
DISPOSITIONS = ("ok", "escalated", "shed", "expired", "error", "rejected")

_KNUTH = 2654435761  # golden-ratio multiplicative hash constant

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager naming the code it wraps ``name`` in a
    `torch.profiler` trace: `torch.profiler.record_function(name)` while a
    profiler is recording, else one shared null context (no torch call
    beyond the check)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def sampled(request_id: int, rate: float) -> bool:
    """Deterministic per-request sampling coin: hash the id, compare the
    top 32 bits against the rate. Same id -> same verdict, every run."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return ((request_id * _KNUTH) & 0xFFFFFFFF) / 2**32 < rate


@dataclass
class Span:
    """One request's flight record. Times are `time.perf_counter()`
    stamps (monotonic seconds); durations derive from their deltas."""

    request_id: int
    tenant_id: str
    t_admit: float
    t_dequeue: float = 0.0       # stamped when a tick batches the request
    tick_id: int = -1            # serving tick that dispatched it (-1: none)
    dispatch_ms: float = 0.0     # fused ACAM dispatch wall time (batch-level)
    escalated: bool = False      # cascade sent it to the CNN head
    disposition: str = ""        # terminal state, one of DISPOSITIONS
    t_done: float = 0.0

    @property
    def queue_ms(self) -> float:
        """Admission -> tick pickup (0 for never-dispatched requests)."""
        if self.t_dequeue <= 0.0:
            return 0.0
        return (self.t_dequeue - self.t_admit) * 1e3

    @property
    def service_ms(self) -> float:
        """Tick pickup -> response (dispatch + cascade + escalation)."""
        if self.t_dequeue <= 0.0 or self.t_done <= 0.0:
            return 0.0
        return (self.t_done - self.t_dequeue) * 1e3

    @property
    def total_ms(self) -> float:
        if self.t_done <= 0.0:
            return 0.0
        return (self.t_done - self.t_admit) * 1e3

    def as_dict(self) -> dict:
        return {
            "request_id": self.request_id,
            "tenant_id": self.tenant_id,
            "tick_id": self.tick_id,
            "disposition": self.disposition,
            "escalated": self.escalated,
            "queue_ms": round(self.queue_ms, 4),
            "dispatch_ms": round(self.dispatch_ms, 4),
            "service_ms": round(self.service_ms, 4),
            "total_ms": round(self.total_ms, 4),
        }


@dataclass
class SpanRecorder:
    """Open/close ledger for request spans.

    `active` holds in-flight spans keyed by request id; `finish` pops —
    a request can therefore neither finish twice nor finish without
    having started, which is what makes span conservation a structural
    property rather than a test assertion.
    """

    sample_rate: float = 1.0
    keep: int = 512              # finished spans retained for inspection
    active: dict[int, Span] = field(default_factory=dict)
    finished: deque = field(default_factory=lambda: deque(maxlen=512))
    started_total: int = 0
    finished_total: int = 0
    by_disposition: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        self.finished = deque(maxlen=self.keep)

    def start(self, request_id: int, tenant_id: str,
              t_admit: float | None = None) -> Span | None:
        """Open a span at admission. Returns None when sampled out (the
        conservation counters still tick, so accounting stays exact)."""
        self.started_total += 1
        if not sampled(request_id, self.sample_rate):
            return None
        span = Span(request_id, tenant_id,
                    time.perf_counter() if t_admit is None else t_admit)
        self.active[request_id] = span
        return span

    def dequeue(self, request_id: int, tick_id: int,
                t_dequeue: float) -> None:
        """Stamp tick pickup (batch-level: one perf_counter per tick,
        shared by every request in the batch — not one syscall each)."""
        span = self.active.get(request_id)
        if span is not None:
            span.t_dequeue = t_dequeue
            span.tick_id = tick_id

    def set_dispatch(self, request_id: int, dispatch_ms: float) -> None:
        span = self.active.get(request_id)
        if span is not None:
            span.dispatch_ms = dispatch_ms

    def finish(self, request_id: int, disposition: str,
               escalated: bool = False,
               t_done: float | None = None) -> Span | None:
        """Close a span exactly once; unknown/sampled-out ids only bump
        the conservation counters."""
        if disposition not in DISPOSITIONS:
            raise ValueError(f"unknown disposition {disposition!r}; "
                             f"expected one of {DISPOSITIONS}")
        self.finished_total += 1
        self.by_disposition[disposition] = \
            self.by_disposition.get(disposition, 0) + 1
        span = self.active.pop(request_id, None)
        if span is None:
            return None
        span.disposition = disposition
        span.escalated = escalated
        span.t_done = time.perf_counter() if t_done is None else t_done
        self.finished.append(span)
        return span

    @property
    def in_flight(self) -> int:
        return len(self.active)

    def conservation(self) -> dict:
        """started == finished + in-flight must hold at every quiescent
        point; the chaos/burst tests assert exactly this."""
        return {
            "started": self.started_total,
            "finished": self.finished_total,
            "in_flight": len(self.active),
            "by_disposition": dict(self.by_disposition),
        }
