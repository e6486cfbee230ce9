"""Replayable load + chaos traces for the port's serving tier.

A twin of the JAX package's `benchmarks/traces.py`. A *trace* is a
deterministic op list (submits, ticks, tenant churn) generated from a
seeded `TraceConfig`: bursty arrivals (alternating burst/calm phases) over
a Zipf-skewed tenant popularity. The same config always yields the same
trace, so the chaos harness replays one trace twice (clean, and with a
kill injected) and compares.

`replay` drives a `HybridService` through a trace and returns p99 latency
split by burst/calm phase, shed and escalation counts, and, when a
`ChaosPlan` injects a mid-stream kill, the snapshot-restore recovery time.
Chaos events are positioned by tick index; ``lose_devices_at`` /
``heal_at_tick`` fail devices over through `HybridService.
handle_device_loss` / `restore_devices` (indices into
`repro_torch.distributed.context.devices()`: a forced mesh's entries on
one card).

Used by `repro_torch.benchmarks.serving_bench` (the burst and chaos rows).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Seeded generator config — equal configs generate equal traces."""

    seed: int = 0
    tenants: int = 8
    classes: int = 10
    num_features: int = 64
    requests: int = 512  # total submits across all phases
    zipf_a: float = 1.2  # tenant popularity skew (larger = more skewed)
    burst: int = 96  # submits per burst phase
    calm: int = 4  # submits per calm phase
    phase_ticks: int = 4  # ticks after each phase's submits
    churn_every: int = 0  # evict+re-register a cold tenant every k-th
    #                       phase (0: no churn)
    query_noise: float = 0.8  # feature noise (drives the escalation rate)


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Failures to inject while replaying, positioned by tick index."""

    ckpt: object = None  # Checkpointer backing kill/restore
    snapshot_every: int = 8  # snapshot cadence in ticks (0: never)
    kill_at_tick: int | None = None  # SIGKILL-equivalent: drop the service
    #                                  object, restore from the checkpoint
    lose_devices_at: int | None = None  # simulate device loss at this tick
    lose: tuple[int, ...] = (1,)  # which device indices fail
    heal_at_tick: int | None = None  # restore_devices at this tick


def zipf_weights(cfg: TraceConfig) -> np.ndarray:
    """Tenant popularity ∝ 1/(rank+1)^a over a seeded rank shuffle (which
    tenant is hot differs per seed; the skew shape does not)."""
    rng = np.random.RandomState(cfg.seed ^ 0x5EED)
    ranks = rng.permutation(cfg.tenants)
    w = 1.0 / np.power(ranks + 1.0, cfg.zipf_a)
    return w / w.sum()


def make_trace(cfg: TraceConfig) -> list[tuple]:
    """The deterministic op list. Ops:

    ``("submit", tenant_idx, qseed, phase)`` — one request, ``phase`` in
    {"burst", "calm"}; ``("tick", phase)``; ``("evict", tenant_idx)`` /
    ``("register", tenant_idx)`` — the churn pair. Ends with drain ticks.
    """
    rng = np.random.RandomState(cfg.seed)
    weights = zipf_weights(cfg)
    coldest = int(np.argmin(weights))
    ops: list[tuple] = []
    submitted = 0
    phase_i = 0
    while submitted < cfg.requests:
        phase = "burst" if phase_i % 2 == 0 else "calm"
        n = min(cfg.burst if phase == "burst" else cfg.calm,
                cfg.requests - submitted)
        for _ in range(n):
            t = int(rng.choice(cfg.tenants, p=weights))
            ops.append(("submit", t, cfg.seed * 100_003 + submitted, phase))
            submitted += 1
        ops.extend([("tick", phase)] * cfg.phase_ticks)
        phase_i += 1
        if cfg.churn_every and phase_i % cfg.churn_every == 0:
            # churn the coldest tenant: its queued requests (if any) resolve
            # against the re-registered placement at tick time
            ops.append(("evict", coldest))
            ops.append(("register", coldest))
    ops.extend([("tick", "drain")] * 64)  # bounded drain tail
    return ops


class TenantPool:
    """Deterministic synthetic tenants + per-submit queries for a trace.

    Banks, heads and prototypes come from `make_synthetic_tenant` keyed on
    the trace seed, so a restarted process regenerates the exact same
    tenants — which is what lets the chaos harness compare results across
    a kill/restore.
    """

    def __init__(self, cfg: TraceConfig):
        from repro_torch.serve import acam_service as svc_lib

        self.cfg = cfg
        self.banks, self.heads, self.protos = [], [], []
        for t in range(cfg.tenants):
            bank, head, p = svc_lib.make_synthetic_tenant(
                cfg.seed * 1000 + t, num_classes=cfg.classes,
                num_features=cfg.num_features)
            self.banks.append(bank)
            self.heads.append(head)
            self.protos.append(p)

    def tenant_id(self, t: int) -> str:
        return f"t{t}"

    def register(self, svc, t: int) -> None:
        svc.register_tenant(self.tenant_id(t), self.banks[t],
                            head=self.heads[t])

    def register_all(self, svc) -> None:
        for t in range(self.cfg.tenants):
            self.register(svc, t)

    def request(self, t: int, qseed: int):
        from repro_torch.serve import acam_service as svc_lib

        feats, _ = svc_lib.sample_tenant_queries(
            qseed, self.protos[t], 1, noise=self.cfg.query_noise)
        return svc_lib.ClassifyRequest(self.tenant_id(t), feats[0])


def replay(svc, trace: list[tuple], pool: TenantPool, *,
           chaos: ChaosPlan | None = None):
    """Drive ``svc`` through ``trace``, injecting ``chaos`` if given.

    Returns ``(svc, stats)`` — the service comes BACK because a chaos kill
    replaces it (the restored incarnation finishes the trace). ``stats``
    carries the resilience numbers: phase-split latencies, responses by
    disposition, and recovery/downtime timings for injected failures.
    """
    from repro_torch.serve.acam_service import AdmissionError

    lat = {"burst": [], "calm": [], "drain": []}
    stats = {"submitted": 0, "rejected": 0, "completed": 0, "errors": 0,
             "shed": 0, "escalated": 0, "recovery_ms": None,
             "lost_in_flight": 0, "device_loss_downtime_ms": None,
             "killed": False}
    ticks = 0
    for op in trace:
        kind = op[0]
        if kind == "submit":
            _, t, qseed, _phase = op
            try:
                svc.submit(pool.request(t, qseed))
                stats["submitted"] += 1
            except AdmissionError:
                stats["rejected"] += 1
        elif kind == "evict":
            tid = pool.tenant_id(op[1])
            if tid in svc.registry:
                svc.evict_tenant(tid)
        elif kind == "register":
            if pool.tenant_id(op[1]) not in svc.registry:
                pool.register(svc, op[1])
        elif kind == "tick":
            for r in svc.step():
                stats["completed"] += 1
                stats["errors"] += r.error is not None
                stats["shed"] += r.shed
                stats["escalated"] += r.escalated
                if r.error is None:
                    lat[op[1]].append(r.latency_s)
            ticks += 1
            if chaos is not None:
                svc = _inject(svc, chaos, ticks, stats)
    for phase in ("burst", "calm"):
        key = f"p99_{phase}_ms"
        stats[key] = (round(float(np.percentile(lat[phase], 99)) * 1e3, 3)
                      if lat[phase] else None)
    return svc, stats


def _inject(svc, chaos: ChaosPlan, ticks: int, stats: dict):
    """Apply the chaos plan's events scheduled for tick ``ticks``."""
    from repro_torch.serve.control import HybridService

    if chaos.ckpt is not None and chaos.snapshot_every \
            and ticks % chaos.snapshot_every == 0:
        svc.snapshot(chaos.ckpt)
    if ticks == chaos.kill_at_tick:
        if chaos.ckpt is None:
            raise ValueError("ChaosPlan.kill_at_tick needs a ckpt")
        if chaos.ckpt.latest_step() is None:
            svc.snapshot(chaos.ckpt)  # never kill before first durability
        # the kill: the in-flight queue dies with the object; the durable
        # state survives. The loss is read from the public health() view.
        stats["lost_in_flight"] = svc.health()["queue_depth"]
        stats["killed"] = True
        device = svc.device
        del svc
        t0 = time.perf_counter()
        svc, _report = HybridService.restore(chaos.ckpt, device=device)
        stats["recovery_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    if ticks == chaos.lose_devices_at:
        report = svc.handle_device_loss(chaos.lose)
        stats["device_loss_downtime_ms"] = round(report.downtime_s * 1e3, 3)
        stats["post_loss_bank_shards"] = svc.registry.bank_shards
    if ticks == chaos.heal_at_tick:
        svc.restore_devices()
    return svc
