"""Serving-tier benchmark of the port: the multi-tenant ACAM service under
load, on the card unless the caller asks for the CPU.

A twin of the single-device rows of the JAX package's
`benchmarks/serving_bench.py`, at its sizes (``NUM_FEATURES`` 64, 10
classes a tenant, its tenant and slot grids and trace configs), so the rows
line up with ``BENCH_serving.json`` row for row. Every measurement builds
its service through the spec path (`HybridService.from_spec`):

  * the sweep (`bench_service`): tenants x slots, a mixed-tenant burst
    served end to end (admission, one matching kernel call per tick, the
    confidence cascade, §V-D energy attribution), plus one row through the
    device-physics backend;
  * `burst_bench`: a seeded bursty Zipf trace with the overload policy
    armed, p99 by burst and calm phase and the shed rate, re-derived from
    the flight recorder's event log;
  * `chaos_bench`: the service killed mid-trace and restored from its
    snapshot; the recovery time from the event log, and the restored
    service checked bit-identical against a clean build;
  * `telemetry_overhead_bench` and `megakernel_bench`: one identical
    stream served twice (spans off / full recorder; ``serve_fusion``
    compose / mega) in turns, the per-arm median us/request, answers
    required identical.

  * `lm_cache_bench`: the ACAM semantic cache in front of LM decode (the
    SMOKE tinyllama, random weights from the seed), a decode-only baseline
    row and one row per exact hit rate 0, 0.5 and 0.9.

The sharded rows need a mesh with a model axis: under ``REPRO_FORCE_MESH``
(a forced mesh, one device repeated: its shards run in turn on that
device) `bank_scaling_sweep` adds a sharded row beside each replicated
one, `reshard_bench` prices the drained 1 -> 2 reshard and `autopilot_bench`
the autopilot's double-buffered flip against it, and `chaos_bench` runs at
two shards; without one they are skipped, as in the JAX bench.

``BENCH_torch_serving.json`` (or ``--out PATH``) keeps the JAX schema, with
the kernel bench's ``backend`` / ``kernels`` / ``card`` in place of
``interpret``. Requests/s and latencies are host-clock numbers of the
device it ran on; escalation rate, nJ/request, occupancy and dispatch
counts do not depend on it.

    python -m repro_torch.benchmarks.serving_bench [--smoke] [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.device import resolve

TENANT_SWEEP = (1, 8, 64)
SLOT_SWEEP = (1, 256)
SMOKE_TENANTS = (1, 8)
SMOKE_SLOTS = (1, 64)
NUM_FEATURES = 64
NUM_CLASSES = 10
#: interleaved passes of each arm in the twice-served rows
PASSES = 9


class BenchError(RuntimeError):
    """A row's own check failed (answers differ, a count disagrees)."""


def make_spec(slots: int, *, requests: int, backend: str | None = None,
              bank_shards: int = 1, install_mesh: bool = False,
              telemetry_dir: str | None = None, span_sample: float = 1.0):
    """The bench's one `ServiceSpec`. Taus ride in match-count units; the
    service converts them itself. ``install_mesh`` lets the spec own a
    (data, model = ``bank_shards``) mesh; ``telemetry_dir`` arms the
    flight recorder's JSONL event log."""
    from repro_torch import match as match_lib
    from repro_torch.match.config import EngineConfig
    from repro_torch.serve import spec as spec_lib

    return spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(
            num_features=NUM_FEATURES,
            initial_classes=spec_lib.aligned_classes(bank_shards)),
        engine=EngineConfig(backend=backend or match_lib.default_backend(),
                            margin=True),
        mesh=spec_lib.MeshSpec(bank_shards=bank_shards,
                               install=install_mesh),
        scheduler=spec_lib.SchedulerSpec(slots=slots),
        cascade=spec_lib.CascadeSpec(tau=8.0, tau_units="count",
                                     max_queue=max(requests, 4096)),
        obs=spec_lib.ObsSpec(telemetry_dir=telemetry_dir,
                             span_sample=span_sample),
    )


def _tenants_and_stream(svc, tenants: int, requests: int, seed: int,
                        classes: int = NUM_CLASSES) -> list:
    """Register ``tenants`` synthetic tenants; the bench's request stream
    (tenant drawn per request from ``seed``)."""
    from repro_torch.serve import acam_service as svc_lib

    protos = []
    for t in range(tenants):
        bank, head, p = svc_lib.make_synthetic_tenant(
            seed * 1000 + t, num_classes=classes, num_features=NUM_FEATURES)
        svc.register_tenant(f"t{t}", bank, head=head)
        protos.append(p)
    rng = np.random.RandomState(seed)
    reqs = []
    for i, t in enumerate(rng.randint(0, tenants, size=requests)):
        feats, _ = svc_lib.sample_tenant_queries(seed + i, protos[t], 1,
                                                 noise=0.8)
        reqs.append(svc_lib.ClassifyRequest(f"t{t}", feats[0]))
    return reqs


def _row(m: dict, **fields) -> dict:
    """A row's own fields, then the metrics every row carries."""
    return {**fields, "requests_per_s": m["requests_per_s"],
            "latency_p50_ms": m["latency_p50_ms"],
            "latency_p99_ms": m["latency_p99_ms"],
            "escalation_rate": m["escalation_rate"],
            "nj_per_request": m["nj_per_request"],
            "occupancy": m["occupancy"],
            "classify_dispatches": m["classify_dispatches"]}


def _signature(responses) -> list:
    return [(r.tenant_id, r.pred, r.escalated, round(r.margin, 6))
            for r in responses]


def bench_service(tenants: int, slots: int, *, requests: int | None = None,
                  seed: int = 0, backend: str | None = None,
                  classes: int = NUM_CLASSES, device=None) -> dict:
    """Serve a mixed-tenant burst through a fresh spec-built service on
    ``device``; one warm-up request first, then the metrics are reset.
    The registry aligns to whatever mesh is installed (`bank_scaling_sweep`
    installs one around its sharded rows)."""
    from repro_torch import match as match_lib
    from repro_torch.serve.control import HybridService

    requests = requests or max(4 * slots, 128)
    svc = HybridService.from_spec(make_spec(
        slots, requests=requests, backend=backend,
        bank_shards=match_lib.bank_shards_in_mesh()), device=device)
    reqs = _tenants_and_stream(svc, tenants, requests, seed, classes)
    svc.serve(reqs[:1])
    svc.reset_metrics()
    responses = svc.serve(reqs)
    if len(responses) != requests:
        raise BenchError(f"{len(responses)} responses to {requests} "
                         "requests")
    return _row(svc.metrics(), tenants=tenants, slots=slots,
                requests=requests, classes=classes,
                matching_backend=backend or "default",
                bank_sharding=svc.registry.bank_shards)


def _report(e):
    print(f"tenants={e['tenants']:3d} classes={e['classes']:3d} "
          f"slots={e['slots']:4d} shards={e['bank_sharding']} "
          f"backend={e['matching_backend']:9s}: "
          f"{e['requests_per_s']:9.1f} req/s, "
          f"p50 {e['latency_p50_ms']} / p99 {e['latency_p99_ms']} ms, "
          f"escalation {e['escalation_rate']:.3f}, "
          f"{e['nj_per_request']:.2f} nJ/req, "
          f"occupancy {e['occupancy']:.2f}, "
          f"{e['classify_dispatches']} dispatches")


def bank_scaling_sweep(*, smoke: bool = False, seed: int = 0,
                       device=None) -> list[dict]:
    """Grow the super-bank (tenants x classes), replicated and, under
    ``REPRO_FORCE_MESH``, with the forced mesh installed around a second
    measurement of each point (the engine then cuts the bank over the
    model axis); without one only the replicated rows. The rows' fields
    are the JAX bench's."""
    from repro_torch.distributed import context, forcemesh

    grid = ((4, 16), (8, 32)) if smoke else ((8, 16), (32, 32), (64, 48))
    slots = min(SLOT_SWEEP[-1], 64)
    spec = forcemesh.env_spec()
    dev = resolve(device)
    entries = []
    for tenants, classes in grid:
        requests = 2 * slots if smoke else 4 * slots
        context.clear()
        entries.append(bench_service(tenants, slots, requests=requests,
                                     seed=seed, classes=classes,
                                     device=dev))
        _report(entries[-1])
        if spec is None:
            continue
        forcemesh.install(spec, device=dev)
        try:
            entries.append(bench_service(tenants, slots, requests=requests,
                                         seed=seed, classes=classes,
                                         device=dev))
        finally:
            context.clear()
        _report(entries[-1])
    return entries


def _sharded_devices(device, shards: int) -> bool:
    """A forced mesh is requested and its devices divide ``shards``."""
    from repro_torch.distributed import context, forcemesh

    return forcemesh.env_spec() is not None \
        and len(context.devices(device)) % shards == 0


def reshard_bench(*, seed: int = 0, tenants: int = 8, slots: int = 64,
                  to_shards: int = 2, device=None) -> dict | None:
    """Live-reshard downtime: boot a spec-built service at one shard (the
    spec owns the mesh), load it, then `reconfigure` to ``to_shards``
    mid-stream and measure the drain -> resume wall time. The answers
    must be the same across the transition, and the scheduler must keep
    one engine call per tick under the bank-sharded plan. Needs a forced
    mesh (``REPRO_FORCE_MESH``, devices divisible by ``to_shards``);
    returns None otherwise."""
    from repro_torch import match as match_lib
    from repro_torch.distributed import context
    from repro_torch.serve.control import HybridService

    dev = resolve(device)
    if not _sharded_devices(dev, to_shards):
        print("skipping reshard row: set REPRO_FORCE_MESH (devices must "
              f"divide {to_shards})")
        return None
    context.clear()
    requests = 4 * slots
    try:
        svc = HybridService.from_spec(make_spec(slots, requests=requests,
                                                bank_shards=1,
                                                install_mesh=True),
                                      device=dev)
        reqs = _tenants_and_stream(svc, tenants, requests, seed)
        before = _signature(svc.serve(reqs))
        # mid-stream: enqueue a burst, reconfigure (drains it), resume
        for req in reqs[:slots]:
            svc.submit(req)
        report = svc.reconfigure(svc.spec._replace(
            mesh=svc.spec.mesh._replace(bank_shards=to_shards)))
        if len(report.drained) != slots:
            raise BenchError("the drain lost queued work")
        if (svc.registry.bank_shards, match_lib.bank_shards_in_mesh()) \
                != (to_shards, to_shards):
            raise BenchError("the reshard did not reach the mesh")
        plan, _ = match_lib.plan_for(
            batch=slots, num_classes=svc.registry.capacity_classes)
        if plan.bank_shards != to_shards:
            raise BenchError(f"the tick's plan is {plan}")
        svc.reset_metrics()
        if _signature(svc.serve(reqs)) != before:
            raise BenchError("the reshard changed served results")
        m = svc.metrics()
        if m["classify_dispatches"] != m["ticks"]:
            raise BenchError(f"{m['classify_dispatches']} engine calls in "
                             f"{m['ticks']} ticks")
    finally:
        context.clear()
    entry = _row(m, tenants=tenants, slots=slots, requests=requests,
                 classes=NUM_CLASSES, matching_backend="default",
                 bank_sharding=to_shards,
                 reshard_downtime_ms=round(report.downtime_s * 1e3, 3),
                 tenants_moved=report.tenants_moved)
    print(f"reshard 1->{to_shards}: downtime "
          f"{entry['reshard_downtime_ms']:.1f} ms "
          f"({entry['tenants_moved']} tenants moved, identical answers, "
          f"{m['classify_dispatches']} sharded engine calls)")
    return entry


def _twice_served(build, arms: tuple[str, str], requests: int,
                  what: str) -> tuple[list, list, dict]:
    """Serve one identical stream through two services (``build(arm)`` ->
    (service, requests), each warmed over the whole stream), `PASSES`
    times each in turns; returns each arm's us/request per pass and the
    second arm's best metrics. The answers must be identical."""
    svcs = [build(arm) for arm in arms]
    us = ([], [])
    sigs = [None, None]
    best = None
    for _ in range(PASSES):
        for i, (svc, reqs) in enumerate(svcs):
            svc.reset_metrics()
            sigs[i] = _signature(svc.serve(reqs))
            m = svc.metrics()
            us[i].append(1e6 / m["requests_per_s"])
            if i == 1 and (best is None or
                           m["requests_per_s"] > best["requests_per_s"]):
                best = m
    if sigs[0] != sigs[1]:
        raise BenchError(f"{what} changed served results")
    return us[0], us[1], best


def telemetry_overhead_bench(*, smoke: bool = False, seed: int = 0,
                             device=None) -> dict:
    """The flight recorder's tax: the identical stream served with spans
    sampled out and no JSONL sink, then with the full recorder (every
    request a span, event log on); preds, margins and escalations must be
    identical either way."""
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.control import HybridService

    tenants, slots = 8, 64
    requests = 256 if smoke else 1024
    with tempfile.TemporaryDirectory() as td:
        obs = {"base": spec_lib.ObsSpec(span_sample=0.0),
               "telemetry": spec_lib.ObsSpec(telemetry_dir=td,
                                             span_sample=1.0)}

        def build(arm):
            svc = HybridService.from_spec(make_spec(
                slots, requests=requests)._replace(obs=obs[arm]),
                device=device)
            reqs = _tenants_and_stream(svc, tenants, requests, seed)
            svc.serve(reqs)  # warm-up over the whole stream
            return svc, reqs

        base_all, tel_all, m = _twice_served(
            build, ("base", "telemetry"), requests, "telemetry")
    base_us, tel_us = float(np.median(base_all)), float(np.median(tel_all))
    entry = _row(m, tenants=tenants, slots=slots, requests=requests,
                 classes=NUM_CLASSES, matching_backend="default",
                 bank_sharding=1,
                 telemetry_overhead_pct=round(100.0 * (tel_us - base_us)
                                              / base_us, 2),
                 base_us_per_request=round(base_us, 3),
                 telemetry_us_per_request=round(tel_us, 3))
    print(f"telemetry overhead: {entry['telemetry_overhead_pct']:+.2f}% "
          f"({base_us:.1f} -> {tel_us:.1f} us/request, identical results)")
    return entry


def megakernel_bench(*, smoke: bool = False, seed: int = 0,
                     device=None) -> dict:
    """The resident serve kernel against the composed tick: the identical
    stream through two services that differ only in
    ``EngineConfig.serve_fusion`` ("compose": gather and shift in PyTorch,
    the margins kernel B4, the tau compare; "mega": one B3 launch), at
    tenants 8, slots 32; the answers must be identical."""
    from repro_torch.serve.control import HybridService

    tenants, slots = 8, 32
    requests = 256 if smoke else 1024

    def build(serve_fusion):
        spec = make_spec(slots, requests=requests)
        spec = spec._replace(engine=spec.engine._replace(
            serve_fusion=serve_fusion))
        svc = HybridService.from_spec(spec, device=device)
        reqs = _tenants_and_stream(svc, tenants, requests, seed)
        svc.serve(reqs)
        return svc, reqs

    comp_all, mega_all, m = _twice_served(build, ("compose", "mega"),
                                          requests, "the mega-kernel")
    comp_us, mega_us = float(np.median(comp_all)), float(np.median(mega_all))
    entry = _row(m, tenants=tenants, slots=slots, requests=requests,
                 classes=NUM_CLASSES, matching_backend="default",
                 bank_sharding=1,
                 megakernel_speedup_pct=round(100.0 * (comp_us - mega_us)
                                              / comp_us, 2),
                 compose_us_per_request=round(comp_us, 3),
                 mega_us_per_request=round(mega_us, 3))
    print(f"serve mega-kernel: {entry['megakernel_speedup_pct']:+.2f}% "
          f"({comp_us:.1f} -> {mega_us:.1f} us/request, identical results)")
    return entry


def burst_bench(*, smoke: bool = False, seed: int = 0, device=None) -> dict:
    """p99 under bursts and the shed rate: a seeded bursty Zipf trace
    against a service whose overload policy is armed (``shed_queue``). The
    shed numbers are re-derived from the event log and checked against the
    metrics registry."""
    from repro_torch.benchmarks import traces
    from repro_torch.obs import read_events
    from repro_torch.serve.control import HybridService

    slots = 32
    cfg = traces.TraceConfig(
        seed=seed, tenants=8, classes=NUM_CLASSES,
        num_features=NUM_FEATURES, requests=256 if smoke else 1024,
        burst=128, calm=8, phase_ticks=3)
    with tempfile.TemporaryDirectory() as td:
        spec = make_spec(slots, requests=cfg.requests, telemetry_dir=td)
        spec = spec._replace(
            cascade=spec.cascade._replace(shed_queue=2 * slots))
        svc = HybridService.from_spec(spec, device=device)
        pool = traces.TenantPool(cfg)
        pool.register_all(svc)
        svc.serve([pool.request(0, seed + 1)])  # warm-up
        svc.reset_metrics()
        svc, stats = traces.replay(svc, traces.make_trace(cfg), pool)
        m = svc.metrics()
        events = read_events(svc.obs.events.path)
        tick_lines = [e for e in events if e["kind"] == "tick"]
        shed_ticks = sum(1 for e in tick_lines
                         if e["shed_mode"] and e["fill"])
        shed_requests = sum(e["shed"] for e in tick_lines)
        shed_intervals = sum(1 for e in events if e["kind"] == "shed_on")
    if (shed_ticks, shed_requests) != (m["load_shed_ticks"], m["shed"]):
        raise BenchError(
            f"event log: {shed_ticks} shed ticks, {shed_requests} shed "
            f"requests; metrics: {m['load_shed_ticks']}, {m['shed']}")
    entry = _row(m, tenants=cfg.tenants, slots=slots,
                 requests=cfg.requests, classes=cfg.classes,
                 matching_backend="default",
                 bank_sharding=svc.registry.bank_shards, trace="burst",
                 p99_burst_ms=stats["p99_burst_ms"],
                 p99_calm_ms=stats["p99_calm_ms"],
                 shed_rate=round(shed_requests / max(m["completed"], 1), 4),
                 load_shed_ticks=shed_ticks, shed_intervals=shed_intervals)
    print(f"burst trace: p99 burst {entry['p99_burst_ms']} ms vs calm "
          f"{entry['p99_calm_ms']} ms, shed rate {entry['shed_rate']:.3f} "
          f"({shed_ticks} shed ticks over {shed_intervals} episodes, from "
          "the event log)")
    return entry


def chaos_bench(*, smoke: bool = False, seed: int = 0, device=None) -> dict:
    """Kill and restore: replay a trace with a mid-stream kill (the service
    object dropped: its queue lost, its snapshot kept), restore from the
    snapshot, and require the restored service to serve a probe set as a
    clean build does, bit for bit. ``recovery_ms`` is the event log's
    ``restore`` duration; ``lost_in_flight`` the queue depth on the dead
    service's last ``tick`` line, checked against the replay harness."""
    from repro_torch.benchmarks import traces
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed import context
    from repro_torch.obs import read_events
    from repro_torch.serve.control import HybridService

    dev = resolve(device)
    sharded = _sharded_devices(dev, 2)
    if sharded:
        context.clear()
    slots = 32
    # phase_ticks=1 keeps a standing queue, so the kill catches in-flight
    # work
    cfg = traces.TraceConfig(
        seed=seed, tenants=8, classes=NUM_CLASSES,
        num_features=NUM_FEATURES, requests=192 if smoke else 768,
        burst=64, calm=8, phase_ticks=1)
    with tempfile.TemporaryDirectory() as td:
        spec = make_spec(slots, requests=cfg.requests,
                         bank_shards=2 if sharded else 1,
                         install_mesh=sharded,
                         telemetry_dir=os.path.join(td, "telemetry"))
        ckpt = Checkpointer(os.path.join(td, "ckpt"), keep=3)
        svc = HybridService.from_spec(spec, device=device)
        pool = traces.TenantPool(cfg)
        pool.register_all(svc)
        svc.serve([pool.request(0, seed + 1)])  # warm-up
        svc.reset_metrics()
        chaos = traces.ChaosPlan(ckpt=ckpt, snapshot_every=2,
                                 kill_at_tick=3)
        svc, stats = traces.replay(svc, traces.make_trace(cfg), pool,
                                   chaos=chaos)
        if not stats["killed"] or stats["recovery_ms"] is None:
            raise BenchError("the chaos plan never killed the service")
        m = svc.metrics()
        probe = [pool.request(t % cfg.tenants, 999_000 + t)
                 for t in range(64)]
        sig = _signature(svc.serve(probe))
        clean = HybridService.from_spec(spec._replace(
            obs=spec.obs._replace(telemetry_dir=None)), device=device)
        pool.register_all(clean)
        if sig != _signature(clean.serve(probe)):
            raise BenchError("restored service diverged from a clean build")
        events = read_events(svc.obs.events.path)
        kills = [i for i, e in enumerate(events) if e["kind"] == "restore"]
        if len(kills) != 1:
            raise BenchError(f"expected one restore event, got {kills}")
        if not any(e["kind"] == "snapshot" for e in events[:kills[0]]):
            raise BenchError("no durable snapshot event before the kill")
        pre_ticks = [e for e in events[:kills[0]] if e["kind"] == "tick"]
        lost = pre_ticks[-1]["queue_depth"]
        if lost != stats["lost_in_flight"]:
            raise BenchError(f"event log lost {lost}, harness "
                             f"{stats['lost_in_flight']}")
        recovery_ms = events[kills[0]]["duration_ms"]
    if sharded:
        context.clear()
    entry = _row(m, tenants=cfg.tenants, slots=slots,
                 requests=cfg.requests, classes=cfg.classes,
                 matching_backend="default",
                 bank_sharding=2 if sharded else 1,
                 trace="chaos", recovery_ms=recovery_ms,
                 lost_in_flight=lost)
    print(f"chaos trace: killed mid-stream, restored bit-identical in "
          f"{recovery_ms:.1f} ms ({lost} in-flight lost, "
          f"bank_shards={entry['bank_sharding']}; numbers from the event "
          "log)")
    return entry


def autopilot_bench(*, smoke: bool = True, seed: int = 0,
                    device=None) -> dict | None:
    """The self-driving fleet row: a bursty Zipf churn trace served with
    the `repro_torch.fleet` autopilot on, under a forced mesh.

    Tenants arrive via a `FleetManifest`; the trace's churn ops are further
    manifest applies. The policy escalates ``bank_shards`` under row
    pressure through the double-buffered rolling reshard, and the row
    prices that flip (``flip_downtime_ms``, from the event log's
    ``buffer_flip`` lines) against the drained `reconfigure` measured on
    an identical service (``drained_downtime_ms``). Requires: at least one
    policy flip, the flip below the drained downtime, answers identical to
    a pinned-spec run of the same trace, and every logged
    ``policy_decision`` replaying to its action from its frozen view.
    Needs ``REPRO_FORCE_MESH`` (an even device count); None otherwise."""
    from repro_torch.benchmarks import traces
    from repro_torch.distributed import context
    from repro_torch.fleet import (Autopilot, FleetManifest, PolicySpec,
                                   RegistryView, TenantSpec, explain,
                                   should_compact)
    from repro_torch.obs import read_events
    from repro_torch.serve.control import HybridService

    dev = resolve(device)
    if not _sharded_devices(dev, 2):
        print("skipping autopilot row: set REPRO_FORCE_MESH (even device "
              "count)")
        return None
    slots = 16
    # 6 tenants x 64 classes = 384 registered rows: 0.75 of the doubled
    # 512-row capacity, the policy's row-pressure threshold
    cfg = traces.TraceConfig(
        seed=seed, tenants=6, classes=64, num_features=NUM_FEATURES,
        requests=160 if smoke else 640, burst=48, calm=8, phase_ticks=2,
        churn_every=3)
    manifest = FleetManifest(tenants=tuple(
        TenantSpec(tenant_id=f"t{t}", seed=cfg.seed * 1000 + t,
                   num_classes=cfg.classes)
        for t in range(cfg.tenants)))
    coldest = int(np.argmin(traces.zipf_weights(cfg)))
    without_cold = FleetManifest(tenants=tuple(
        t for t in manifest.tenants if t.tenant_id != f"t{coldest}"))
    pool = traces.TenantPool(cfg)
    trace = traces.make_trace(cfg)

    def serve_trace(svc, pilot):
        sig = []
        for op in trace:
            kind = op[0]
            if kind == "submit":
                svc.submit(pool.request(op[1], op[2]))
            elif kind == "evict":
                svc.apply_manifest(without_cold)
            elif kind == "register":
                svc.apply_manifest(manifest)
            elif kind == "tick":
                sig.extend(_signature(svc.step()))
                if pilot is not None:
                    pilot.observe_tick()
                    sig.extend(_signature(pilot.take_drained()))
        return sig

    def build(spec):
        svc = HybridService.from_spec(spec, device=dev)
        svc.apply_manifest(manifest)
        return svc

    context.clear()
    try:
        with tempfile.TemporaryDirectory() as td:
            spec = make_spec(slots, requests=cfg.requests, bank_shards=1,
                             install_mesh=True,
                             telemetry_dir=os.path.join(td, "telemetry"))
            untraced = spec._replace(obs=spec.obs._replace(
                telemetry_dir=None))
            svc = build(spec)
            svc.serve([pool.request(0, seed + 1)])  # warm-up
            svc.reset_metrics()
            pilot = Autopilot(svc, policy=PolicySpec(interval=4,
                                                     hysteresis=2,
                                                     cooldown=8))
            sig = serve_trace(svc, pilot)
            m = svc.metrics()
            events = read_events(svc.obs.events.path)
            flips = [e for e in events if e["kind"] == "buffer_flip"]
            decisions = [e for e in events
                         if e["kind"] == "policy_decision"]
            applies = sum(1 for e in events
                          if e["kind"] == "manifest_apply")
            if not flips:
                raise BenchError("the autopilot never flipped a buffer")
            if applies < 2:
                raise BenchError("churn never went through the manifest")
            for e in decisions:
                view = RegistryView.from_dict(e["view"])
                act = explain(view, pilot.policy)[0]
                if act == "hold" and should_compact(view, pilot.policy):
                    act = "compact"
                if act != e["action"]:
                    raise BenchError(f"decision replays to {act}, logged "
                                     f"{e['action']}")

            # the pinned-spec arm: same trace and churn, no autopilot
            context.clear()
            pinned = build(untraced)
            pinned.serve([pool.request(0, seed + 1)])
            pinned.reset_metrics()
            if serve_trace(pinned, None) != sig:
                raise BenchError("the autopilot changed served results")

            # the drained alternative on an identical service: full queue,
            # quiesce and reshard 1 -> 2
            context.clear()
            drained_svc = build(untraced)
            warm = [pool.request(t % cfg.tenants, 777_000 + t)
                    for t in range(4 * slots)]
            drained_svc.serve(warm)  # warm every shape
            for r in warm[:slots]:
                drained_svc.submit(r)
            report = drained_svc.reconfigure(drained_svc.spec._replace(
                mesh=drained_svc.spec.mesh._replace(bank_shards=2)))
            if len(report.drained) != slots:
                raise BenchError("the drain lost queued work")
            drained_ms = round(report.downtime_s * 1e3, 3)
    finally:
        context.clear()
    flip_ms = max(e["flip_ms"] for e in flips)
    if flip_ms >= drained_ms:
        raise BenchError(f"flip {flip_ms} ms not below drained "
                         f"{drained_ms} ms")
    entry = _row(m, tenants=cfg.tenants, slots=slots,
                 requests=cfg.requests, classes=cfg.classes,
                 matching_backend="default",
                 bank_sharding=svc.registry.bank_shards, trace="autopilot",
                 flip_downtime_ms=flip_ms, drained_downtime_ms=drained_ms,
                 policy_flips=len(flips), policy_decisions=len(decisions),
                 manifest_applies=applies)
    print(f"autopilot trace: {len(flips)} rolling reshards to "
          f"bank_shards={entry['bank_sharding']}, flip {flip_ms:.2f} ms vs "
          f"drained {drained_ms:.1f} ms ({len(decisions)} policy "
          f"decisions, {applies} manifest applies, identical to the pinned "
          "run)")
    return entry


def lm_cache_bench(*, smoke: bool = False, seed: int = 0,
                   device=None) -> list[dict]:
    """The ACAM semantic cache in front of LM decode, swept over hit rate
    at the JAX bench's sizes.

    One ``serving_lm_decode_only`` row (the bare continuous-batching
    `Engine` over the same prompt set) and one ``serving_lm_cache_h{0,50,
    90}`` row per target hit rate: the bank is warmed with a fixed prompt
    pool, then a measured window of R requests holding EXACTLY round(R*h)
    Zipf-weighted repeats (hits) and R - round(R*h) fresh prompts (decode
    misses) is served through `SemanticCacheService`. The mean ratios are
    amortisation-bounded by 1/(1-h); the hit-path ratios price the hit
    path alone (an all-hit probe burst after the window). Energies are the
    §V-D / per-token models: they do not depend on the device."""
    import time as time_mod

    from repro_torch import configs
    from repro_torch.core.energy import lm_decode_energy
    from repro_torch.models import lm as lm_mod
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.semantic_cache import (PromptRequest,
                                                  SemanticCacheService)

    dev = resolve(device)
    requests = 20 if smoke else 60
    pool_size, plen, max_new, slots = 8, 12, 8, 16
    cfg = configs.get("tinyllama-1.1b", smoke=True)
    params = lm_mod.init_params(seed, cfg, device=dev)
    rng = np.random.RandomState(seed)
    pool = [rng.randint(0, cfg.vocab, size=plen).astype(np.int32)
            for _ in range(pool_size)]
    fresh_pool = [rng.randint(0, cfg.vocab, size=plen).astype(np.int32)
                  for _ in range(requests)]
    zipf = 1.0 / np.arange(1, pool_size + 1) ** 1.2
    zipf /= zipf.sum()

    def measured_trace(h: float) -> tuple[list[np.ndarray], int]:
        n_hit = int(round(requests * h))
        prompts = [pool[i] for i in rng.choice(pool_size, size=n_hit,
                                               p=zipf)]
        prompts += fresh_pool[:requests - n_hit]
        order = np.random.RandomState(seed + 1).permutation(requests)
        return [prompts[i] for i in order], n_hit

    # decode-only baseline: a full-size warm-up pass first, as the JAX
    # bench does (its join shapes compile there; here it warms the
    # allocator and the card's kernels)
    base_eng = Engine(cfg, params, batch_size=4, max_len=64, seed=seed)
    base_prompts, _ = measured_trace(0.0)
    base_eng.generate([Request(prompt=p, max_new_tokens=max_new)
                       for p in base_prompts])
    t0 = time_mod.perf_counter()
    base_eng.generate([Request(prompt=p, max_new_tokens=max_new)
                       for p in base_prompts])
    base_us = (time_mod.perf_counter() - t0) * 1e6 / requests
    base_nj = lm_decode_energy(cfg.active_param_count(),
                               plen + max_new) * 1e9
    entries = [{
        "tenants": 1, "slots": 4, "requests": requests, "classes": 0,
        "matching_backend": "default", "bank_sharding": 1,
        "arch": cfg.name, "lm_baseline": True,
        "us_per_request": round(base_us, 1),
        "decode_energy_nj": round(base_nj, 3),
        "requests_per_s": round(1e6 / base_us, 2),
        "latency_p50_ms": round(base_us / 1e3, 3),
        "latency_p99_ms": round(base_us / 1e3, 3),
        "escalation_rate": 1.0, "nj_per_request": round(base_nj, 3),
        "occupancy": 0.0, "classify_dispatches": 0,
    }]
    print(f"lm decode-only baseline: {base_us:.0f} us/request, "
          f"{base_nj:.1f} nJ/request modelled")

    eng = Engine(cfg, params, batch_size=4, max_len=64, seed=seed)
    for h in (0.0, 0.5, 0.9):
        spec = spec_lib.ServiceSpec(
            registry=spec_lib.RegistrySpec(num_features=NUM_FEATURES),
            scheduler=spec_lib.SchedulerSpec(slots=slots),
            cascade=spec_lib.CascadeSpec(backend="lm", tau=8.0,
                                         tau_units="count",
                                         max_queue=4096),
            router=spec_lib.RouterSpec(
                max_templates=pool_size + requests + slots,
                response_capacity=4096),
            mesh=spec_lib.MeshSpec(install=False))
        svc = SemanticCacheService.from_spec(spec, engine=eng, device=dev)
        svc.add_tenant("edge-0")
        # warm: admit the pool one by one, then one slots-wide all-miss
        # burst, before the measured window
        for p in pool:
            svc.serve_prompts([PromptRequest("edge-0", p,
                                             max_new_tokens=max_new)])
        warm = [rng.randint(0, cfg.vocab, size=plen).astype(np.int32)
                for _ in range(slots)]
        svc.serve_prompts(PromptRequest("edge-0", p, max_new_tokens=max_new)
                          for p in warm)
        svc.reset_metrics()
        prompts, n_hit = measured_trace(h)
        out = []
        t0 = time_mod.perf_counter()
        for i in range(0, requests, slots):
            out.extend(svc.serve_prompts(
                PromptRequest("edge-0", p, max_new_tokens=max_new)
                for p in prompts[i:i + slots]))
        us = (time_mod.perf_counter() - t0) * 1e6 / requests
        hits = sum(r.cache_hit for r in out)
        if hits != n_hit:
            raise BenchError(f"h={h}: {hits} hits, the trace holds {n_hit}")
        m = svc.metrics()
        if m["classify_dispatches"] != m["ticks"]:
            raise BenchError(f"h={h}: {m['classify_dispatches']} matching "
                             f"calls over {m['ticks']} ticks")
        # the hit path alone: an all-hit probe burst after the window
        probe = [pool[i % pool_size] for i in range(slots)]
        t0 = time_mod.perf_counter()
        probed = svc.serve_prompts(
            PromptRequest("edge-0", p, max_new_tokens=max_new)
            for p in probe)
        hit_us = (time_mod.perf_counter() - t0) * 1e6 / slots
        if not all(r.cache_hit for r in probed):
            raise BenchError(f"h={h}: the probe burst missed")
        hit_nj = float(np.median([r.energy_j for r in probed])) * 1e9
        entry = {
            "tenants": 1, "slots": slots, "requests": requests,
            "classes": 0, "matching_backend": "default",
            "bank_sharding": 1, "arch": cfg.name,
            "hit_rate": h,
            "mean_speedup": round(base_us / us, 2),
            "mean_energy_ratio": round(base_nj / m["nj_per_request"], 2)
            if m["nj_per_request"] else None,
            "hit_path_speedup": round(base_us / hit_us, 1),
            "hit_path_energy_ratio": round(base_nj / hit_nj, 1),
            "hit_path_us": round(hit_us, 1),
            "hit_path_nj": round(hit_nj, 4),
            "decode_us_per_request": round(base_us, 1),
            "decode_energy_nj": round(base_nj, 3),
            "requests_per_s": m["requests_per_s"],
            "latency_p50_ms": m["latency_p50_ms"],
            "latency_p99_ms": m["latency_p99_ms"],
            "escalation_rate": m["escalation_rate"],
            "nj_per_request": m["nj_per_request"],
            "occupancy": m["occupancy"],
            "classify_dispatches": m["classify_dispatches"],
        }
        entries.append(entry)
        print(f"lm cache h={h:.1f}: {us:.0f} us/request "
              f"(mean x{entry['mean_speedup']}, "
              f"bound {1 / (1 - h):.0f}x), "
              f"{m['nj_per_request']:.1f} nJ/request; hit path "
              f"{hit_us:.0f} us (x{entry['hit_path_speedup']}), "
              f"{hit_nj:.2f} nJ (x{entry['hit_path_energy_ratio']})")
    return entries


def sweep(*, smoke: bool = False, seed: int = 0, device=None) -> list[dict]:
    """Every row: the tenants x slots grid, the device-physics row, the
    bank-scaling and reshard rows, then the burst, chaos, autopilot,
    telemetry, mega-kernel and semantic-cache rows (the sharded ones
    under ``REPRO_FORCE_MESH`` only)."""
    tenant_grid = SMOKE_TENANTS if smoke else TENANT_SWEEP
    slot_grid = SMOKE_SLOTS if smoke else SLOT_SWEEP

    def requests_for(slots):
        return 2 * max(slots, 32) if smoke else max(4 * slots, 128)

    entries = []
    for tenants in tenant_grid:
        for slots in slot_grid:
            entries.append(bench_service(tenants, slots,
                                         requests=requests_for(slots),
                                         seed=seed, device=device))
            _report(entries[-1])
    # one device-physics row: the same stack through the RRAM-CMOS models
    tenants, slots = tenant_grid[-1], max(slot_grid)
    entries.append(bench_service(tenants, slots,
                                 requests=requests_for(slots), seed=seed,
                                 backend="device", device=device))
    _report(entries[-1])
    entries.extend(bank_scaling_sweep(smoke=smoke, seed=seed, device=device))
    reshard = reshard_bench(seed=seed, device=device)
    if reshard is not None:
        entries.append(reshard)
    entries.append(burst_bench(smoke=smoke, seed=seed, device=device))
    entries.append(chaos_bench(smoke=smoke, seed=seed, device=device))
    pilot_row = autopilot_bench(smoke=smoke, seed=seed, device=device)
    if pilot_row is not None:
        entries.append(pilot_row)
    entries.append(telemetry_overhead_bench(smoke=smoke, seed=seed,
                                            device=device))
    entries.append(megakernel_bench(smoke=smoke, seed=seed, device=device))
    entries.extend(lm_cache_bench(smoke=smoke, seed=seed, device=device))
    return entries


def write_bench_json(entries: list[dict],
                     path: str = "BENCH_torch_serving.json", *,
                     device=None) -> None:
    from repro_torch.benchmarks.kernel_bench import card_name

    dev = resolve(device)
    payload = {
        "backend": dev.type,
        "kernels": "cuda" if dev.type == "cuda" else "plain",
        "card": card_name() if dev.type == "cuda" else None,
        "entries": entries,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def _row_name(e: dict) -> str:
    if e.get("lm_baseline"):
        return "serving_lm_decode_only"
    if "hit_rate" in e:
        return f"serving_lm_cache_h{int(round(e['hit_rate'] * 100))}"
    if "megakernel_speedup_pct" in e:
        return "serving_megakernel"
    if "telemetry_overhead_pct" in e:
        return "serving_telemetry_overhead"
    if "flip_downtime_ms" in e:
        return "serving_autopilot"
    if "reshard_downtime_ms" in e:
        return f"serving_reshard_1to{e['bank_sharding']}"
    if e.get("trace") == "chaos":
        return "serving_chaos_recovery"
    if e.get("trace") == "burst":
        return f"serving_burst_t{e['tenants']}_s{e['slots']}"
    return (f"serving_t{e['tenants']}_c{e['classes']}_s{e['slots']}"
            + ("" if e["bank_sharding"] == 1
               else f"_shard{e['bank_sharding']}")
            + ("" if e["matching_backend"] == "default"
               else f"_{e['matching_backend']}"))


def _row_derived(e: dict) -> str:
    if e.get("lm_baseline"):
        return (f"{e['us_per_request']}us/req,"
                f"{e['decode_energy_nj']}nJ/req,decode-only")
    if "hit_rate" in e:
        return (f"h={e['hit_rate']},mean_x{e['mean_speedup']},"
                f"hitpath_x{e['hit_path_speedup']}us/"
                f"x{e['hit_path_energy_ratio']}nJ,"
                f"{e['nj_per_request']:.1f}nJ/req")
    if "megakernel_speedup_pct" in e:
        return (f"speedup={e['megakernel_speedup_pct']}%,"
                f"compose={e['compose_us_per_request']}us,"
                f"mega={e['mega_us_per_request']}us")
    if "telemetry_overhead_pct" in e:
        return (f"overhead={e['telemetry_overhead_pct']}%,"
                f"base={e['base_us_per_request']}us,"
                f"tel={e['telemetry_us_per_request']}us")
    if "flip_downtime_ms" in e:
        return (f"flip={e['flip_downtime_ms']}ms,"
                f"drained={e['drained_downtime_ms']}ms,"
                f"flips={e['policy_flips']},"
                f"shards={e['bank_sharding']}")
    if "reshard_downtime_ms" in e:
        return (f"downtime={e['reshard_downtime_ms']}ms,"
                f"moved={e['tenants_moved']},"
                f"{e['requests_per_s']:.0f}req/s")
    if e.get("trace") == "chaos":
        return (f"recovery={e['recovery_ms']}ms,"
                f"lost={e['lost_in_flight']},"
                f"{e['requests_per_s']:.0f}req/s")
    if e.get("trace") == "burst":
        return (f"p99_burst={e['p99_burst_ms']}ms,"
                f"shed={e['shed_rate']:.3f},"
                f"{e['requests_per_s']:.0f}req/s")
    return (f"{e['requests_per_s']:.0f}req/s,"
            f"esc={e['escalation_rate']:.3f},"
            f"{e['nj_per_request']:.2f}nJ/req")


def run(*, device=None, out: str = "BENCH_torch_serving.json",
        smoke: bool | None = None) -> list[dict]:
    """The harness contract of `repro_torch.benchmarks.run`: every row on
    ``device`` (the card unless the caller asks for the CPU), ``smoke``
    defaulting to ``REPRO_BENCH_FAST=1``; writes ``out``."""
    if smoke is None:
        smoke = os.environ.get("REPRO_BENCH_FAST", "0") == "1"
    entries = sweep(smoke=smoke, device=device)
    write_bench_json(entries, out, device=device)
    return [{"name": _row_name(e), "us_per_call":
             round(1e6 / e["requests_per_s"], 2)
             if e["requests_per_s"] else 0.0,
             "derived": _row_derived(e), "entry": e} for e in entries]


def main(argv=None, *, device=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small tenant/slot grid and short traces")
    ap.add_argument("--out", default="BENCH_torch_serving.json",
                    help="where the rows go (JSON)")
    ap.add_argument("--device", default=device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    rows = run(device=args.device, out=args.out, smoke=args.smoke)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']},{r['derived']}")
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
