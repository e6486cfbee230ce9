"""`repro_torch.obs` — the serving stack's flight recorder.

Single source of truth for everything the service observes about
itself. Four pieces, one facade:

  * `MetricsRegistry` (`.registry`) — labeled counters/gauges +
    fixed-bucket latency histograms with exact-from-buckets quantiles.
  * `SpanRecorder` (`.spans`) — per-request flight records across
    admission -> queue -> tick -> dispatch -> cascade -> response.
  * `EnergyLedger` (`.energy`) — per-tenant + fleet SS V-D nJ totals
    with the E_backend / E_frontend split, bit-exact with the
    per-response attributions.
  * exporters (`.export`) — JSONL event log, Prometheus text renderer,
    and their validators (the CI telemetry-smoke contract).

`FlightRecorder` wires them together and is what the serving tier
holds: `ACAMService` keeps exactly one, the scheduler borrows it for
tick/dispatch stamps, the control plane borrows it for lifecycle
events, and `metrics()`/`health()` are thin reads over it. Ad-hoc
counters and private `np.percentile` reservoirs in the service are
gone — every consumer of "the p99" reads the one histogram here.

Reset contract (`FlightRecorder.reset`, behind
`ACAMService.reset_metrics()`):

  cleared    counters, cumulative histogram counts, the energy ledger,
             per-run fill aggregates (min/max batch fill)
  surviving  gauges (queue depth, shed mode, straggler strikes), the
             histogram's ROLLING window (the shed_p99_ms overload
             signal — a metrics reset must never blind load shedding),
             span conservation totals (started == finished + in-flight
             is a structural invariant, not a per-run statistic), the
             tick-id sequence, and the event log (append-only).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import deque

from .energy import NJ, EnergyLedger
from .export import (EVENT_SCHEMA, JsonlEventLog, read_events,
                     render_prometheus, validate_event,
                     validate_prometheus_text, write_prometheus)
from .registry import (DEFAULT_LATENCY_BUCKETS_MS, Counter, Gauge,
                       Histogram, MetricsRegistry)
from .spans import DISPOSITIONS, Span, SpanRecorder

__all__ = [
    "FlightRecorder", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "SpanRecorder", "Span", "EnergyLedger", "JsonlEventLog", "read_events",
    "render_prometheus", "validate_prometheus_text", "write_prometheus",
    "validate_event", "EVENT_SCHEMA", "DISPOSITIONS",
    "DEFAULT_LATENCY_BUCKETS_MS", "NJ",
]


class FlightRecorder:
    """The serving tier's one telemetry object.

    Built from an `ObsSpec` (`repro_torch.serve.spec`); a default-constructed
    recorder (no spec) records in memory with no event log — telemetry
    is always *on*, the spec only controls buckets, sampling, the
    JSONL sink, and profiler annotations.
    """

    def __init__(self, obs=None):
        buckets = DEFAULT_LATENCY_BUCKETS_MS
        window = 256
        sample = 1.0
        telemetry_dir = None
        self.profile_annotations = False
        if obs is not None:
            # () in the spec means "the default bucket ladder"
            buckets = tuple(obs.latency_buckets_ms) or buckets
            window = obs.latency_window
            sample = obs.span_sample
            telemetry_dir = obs.telemetry_dir
            self.profile_annotations = obs.profile_annotations
        self.registry = MetricsRegistry()
        self.spans = SpanRecorder(sample_rate=sample)
        self.ledger = EnergyLedger()
        self.events = JsonlEventLog(
            os.path.join(telemetry_dir, "events.jsonl")
            if telemetry_dir else None)
        self.tick_seq = 0

        r = self.registry
        self.latency = r.histogram(
            "acam_request_latency_ms",
            "submit -> response wall time of error-free responses (ms)",
            buckets=buckets, window=window)
        self.submitted = r.counter(
            "acam_requests_submitted_total", "requests admitted to the queue")
        self.rejected = r.counter(
            "acam_requests_rejected_total", "requests refused at admission")
        self.responses = r.counter(
            "acam_responses_total",
            "responses by terminal disposition (ok/escalated/shed/"
            "expired/error)")
        self.energy = r.counter(
            "acam_energy_joules_total",
            "SS V-D attributed energy by stage (backend=ACAM array, "
            "frontend=CNN head) and tenant")
        self.esc_dispatches = r.counter(
            "acam_escalation_dispatches_total",
            "coalesced dense-head dispatches (one per tick with "
            "escalations)")
        self.cache_events = r.counter(
            "acam_semantic_cache_events_total",
            "semantic-cache router outcomes "
            "(event=hit/miss/insert/evict)")
        self.cache_hit_latency = r.histogram(
            "acam_cache_hit_latency_ms",
            "submit -> response wall time of semantic-cache hits (ms)",
            buckets=buckets, window=window)
        self.decode_latency = r.histogram(
            "acam_lm_decode_latency_ms",
            "submit -> response wall time of cache misses escalated to "
            "LM decode (ms)",
            buckets=buckets, window=window)
        self.load_shed_ticks = r.counter(
            "acam_load_shed_ticks_total", "ticks served in load-shed mode")
        self.busy_seconds = r.counter(
            "acam_service_busy_seconds_total",
            "wall time spent inside step()")
        self.ticks = r.counter(
            "acam_scheduler_ticks_total", "scheduler ticks that dispatched")
        self.dispatches = r.counter(
            "acam_scheduler_dispatches_total",
            "fused classify dispatches (== ticks: ONE per tick)")
        self.served = r.counter(
            "acam_scheduler_served_total", "requests served by a dispatch")
        self.filled_slots = r.counter(
            "acam_scheduler_filled_slots_total",
            "slots occupied across all dispatches (occupancy numerator)")
        self.tick_seconds = r.counter(
            "acam_scheduler_tick_seconds_total",
            "summed dispatch wall time")
        self.slow_ticks = r.counter(
            "acam_scheduler_slow_ticks_total",
            "ticks flagged by the straggler monitor")
        self.expired = r.counter(
            "acam_scheduler_expired_total",
            "requests expired past their queue deadline")
        self.queue_depth = r.gauge(
            "acam_queue_depth", "requests waiting in the scheduler queue")
        self.shed_mode = r.gauge(
            "acam_shed_mode", "1 when the next tick runs in load-shed mode")
        self.slots_gauge = r.gauge(
            "acam_scheduler_slots", "micro-batch slot count")
        self.fill_min = r.gauge(
            "acam_batch_fill_min", "smallest batch fill this run",
            clear_on_reset=True)
        self.fill_max = r.gauge(
            "acam_batch_fill_max", "largest batch fill this run",
            clear_on_reset=True)
        self.straggler_strikes = r.gauge(
            "acam_straggler_strikes",
            "consecutive slow-tick strikes per host "
            "(repro_torch.ft.elastic.StragglerMonitor)")
        self.straggler_deadline = r.gauge(
            "acam_straggler_deadline_seconds",
            "current straggler deadline (rolling-median based)")
        self._shed_state = False
        self.last_dispatch_ms = 0.0  # most recent fused-dispatch wall time
        #: rolling per-tick batch fills (the fleet policy's saturation
        #: signal — like the latency window, it describes the service NOW
        #: and survives `reset()`)
        self.fill_window: deque = deque(maxlen=64)

    # -- admission ---------------------------------------------------------

    def record_submit(self, request_id: int, tenant_id: str,
                      t_admit: float) -> None:
        self.submitted.inc()
        self.spans.start(request_id, tenant_id, t_admit)

    def record_rejected(self) -> None:
        self.rejected.inc()

    # -- scheduler hooks ---------------------------------------------------

    def record_tick_dispatch(self, request_ids, fill: int, dt_s: float,
                             slow: bool, t_dequeue: float) -> int:
        """One fused dispatch happened: allocate the tick id, stamp every
        batched span with it (batch-level — one clock read for the whole
        tick, not one per request), and feed the scheduler counters."""
        tick_id = self.tick_seq
        self.tick_seq += 1
        dt_ms = dt_s * 1e3
        self.last_dispatch_ms = dt_ms
        for rid in request_ids:
            span = self.spans.active.get(rid)
            if span is not None:
                span.t_dequeue = t_dequeue
                span.tick_id = tick_id
                span.dispatch_ms = dt_ms
        self.ticks.inc()
        self.dispatches.inc()
        self.served.inc(fill)
        self.filled_slots.inc(fill)
        self.tick_seconds.inc(dt_s)
        self.slow_ticks.inc(int(slow))
        self.fill_min.set_min(fill)
        self.fill_max.set_max(fill)
        self.fill_window.append(fill)
        return tick_id

    def record_expired(self, n: int) -> None:
        self.expired.inc(n)

    def record_straggler(self, verdict: dict, flagged: dict) -> None:
        """StragglerMonitor -> registry: per-host strike gauges + the
        current deadline (`ft.elastic` feeds this after every heartbeat)."""
        self.straggler_deadline.set(verdict.get("deadline_s", 0.0))
        for host, strikes in flagged.items():
            self.straggler_strikes.set(strikes, host=host)

    def profile_span(self, name: str):
        """Context manager annotating the fused dispatch in `torch.profiler`
        traces (no-op unless `ObsSpec.profile_annotations`)."""
        if not self.profile_annotations:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    # -- cascade / response ------------------------------------------------

    def record_shed_tick(self) -> None:
        self.load_shed_ticks.inc()

    # -- semantic-cache router ---------------------------------------------

    def record_cache_event(self, event: str, n: int = 1) -> None:
        """One semantic-cache router outcome: "hit" (served from the
        response store), "miss" (escalated to decode), "insert" (template
        + response admitted), "evict" (template row invalidated by LRU
        pressure). Conservation: hit + miss == error-free routed
        responses; insert - evict == live templates."""
        self.cache_events.inc(n, event=event)

    def record_cache_latency(self, hit: bool, latency_s: float) -> None:
        """Feed the hit-vs-decode histogram pair: the two distributions
        whose gap IS the semantic cache's latency win."""
        h = self.cache_hit_latency if hit else self.decode_latency
        h.observe(latency_s * 1e3)

    def record_escalation_dispatch(self) -> None:
        self.esc_dispatches.inc()

    def finish_request(self, resp, backend_j: float,
                       frontend_j: float) -> None:
        """Close one request: disposition counter, latency observation
        (error-free responses only — expired/evicted latencies measure
        the queue deadline, not service), energy ledger + stage counters,
        and the span."""
        if resp.error is not None:
            disposition = "expired" if "deadline" in resp.error else "error"
        elif resp.shed:
            disposition = "shed"
        elif resp.escalated:
            disposition = "escalated"
        else:
            disposition = "ok"
        self.responses.inc(disposition=disposition)
        if resp.error is None:
            self.latency.observe(resp.latency_s * 1e3)
        self.ledger.add(resp.tenant_id, backend_j, frontend_j,
                        escalated=resp.escalated, shed=resp.shed)
        if backend_j:
            self.energy.inc(backend_j, stage="backend",
                            tenant=resp.tenant_id)
        if frontend_j:
            self.energy.inc(frontend_j, stage="frontend",
                            tenant=resp.tenant_id)
        self.spans.finish(resp.request_id, disposition,
                          escalated=resp.escalated)

    def add_busy(self, seconds: float) -> None:
        self.busy_seconds.inc(seconds)

    # -- health signals ----------------------------------------------------

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth.set(depth)

    def set_shed_mode(self, shedding: bool, *, queue_depth: int) -> None:
        """Track the overload flag; a FLIP emits a shed_on/shed_off event
        (the bench's shed-interval reconstruction reads these)."""
        self.shed_mode.set(int(shedding))
        if shedding != self._shed_state:
            self._shed_state = shedding
            self.emit("shed_on" if shedding else "shed_off",
                      queue_depth=queue_depth,
                      p99_ms=round(self.latency_quantile_ms(0.99), 4))

    def rolling_batch_fill(self) -> float:
        """Mean batch fill over the rolling tick window — the fleet
        policy's "sustained saturation" input (a single full tick never
        reads as saturation; a full WINDOW does)."""
        if not self.fill_window:
            return 0.0
        return sum(self.fill_window) / len(self.fill_window)

    def latency_quantile_ms(self, q: float) -> float:
        """THE latency quantile — `metrics()`, `health()`, and the
        shed_p99_ms overload check all call this, so they can never
        disagree (reads the rolling window; survives `reset`)."""
        return self.latency.quantile(q)

    # -- events / export ---------------------------------------------------

    def emit(self, kind: str, **payload) -> None:
        self.events.emit(kind, **payload)

    def render_prometheus(self) -> str:
        return render_prometheus(self.registry)

    def reset(self) -> None:
        """See the module docstring for the exact clear/survive split."""
        self.registry.reset()
        self.ledger.clear()

    def close(self) -> None:
        self.events.close()
