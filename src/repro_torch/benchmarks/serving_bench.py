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

Not here: the bank-scaling, reshard and autopilot rows (the super-bank
sharded over several cards: the multi-GPU slice) and the LM semantic-cache
rows (the LM slice).

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
              telemetry_dir: str | None = None, span_sample: float = 1.0):
    """The bench's one `ServiceSpec` (one card: no mesh to install). Taus
    ride in match-count units; the service converts them itself.
    ``telemetry_dir`` arms the flight recorder's JSONL event log."""
    from repro_torch import match as match_lib
    from repro_torch.match.config import EngineConfig
    from repro_torch.serve import spec as spec_lib

    return spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(
            num_features=NUM_FEATURES,
            initial_classes=spec_lib.aligned_classes(1)),
        engine=EngineConfig(backend=backend or match_lib.default_backend(),
                            margin=True),
        mesh=spec_lib.MeshSpec(bank_shards=1, install=False),
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
    ``device``; one warm-up request first, then the metrics are reset."""
    from repro_torch.serve.control import HybridService

    requests = requests or max(4 * slots, 128)
    svc = HybridService.from_spec(make_spec(slots, requests=requests,
                                            backend=backend), device=device)
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
    from repro_torch.obs import read_events
    from repro_torch.serve.control import HybridService

    slots = 32
    # phase_ticks=1 keeps a standing queue, so the kill catches in-flight
    # work
    cfg = traces.TraceConfig(
        seed=seed, tenants=8, classes=NUM_CLASSES,
        num_features=NUM_FEATURES, requests=192 if smoke else 768,
        burst=64, calm=8, phase_ticks=1)
    with tempfile.TemporaryDirectory() as td:
        spec = make_spec(slots, requests=cfg.requests,
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
    entry = _row(m, tenants=cfg.tenants, slots=slots,
                 requests=cfg.requests, classes=cfg.classes,
                 matching_backend="default", bank_sharding=1,
                 trace="chaos", recovery_ms=recovery_ms,
                 lost_in_flight=lost)
    print(f"chaos trace: killed mid-stream, restored bit-identical in "
          f"{recovery_ms:.1f} ms ({lost} in-flight lost; numbers from the "
          "event log)")
    return entry


def sweep(*, smoke: bool = False, seed: int = 0, device=None) -> list[dict]:
    """Every row: the tenants x slots grid, the device-physics row, then
    the burst, chaos, telemetry and mega-kernel rows."""
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
    entries.append(burst_bench(smoke=smoke, seed=seed, device=device))
    entries.append(chaos_bench(smoke=smoke, seed=seed, device=device))
    entries.append(telemetry_overhead_bench(smoke=smoke, seed=seed,
                                            device=device))
    entries.append(megakernel_bench(smoke=smoke, seed=seed, device=device))
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
    if "megakernel_speedup_pct" in e:
        return "serving_megakernel"
    if "telemetry_overhead_pct" in e:
        return "serving_telemetry_overhead"
    if e.get("trace") == "chaos":
        return "serving_chaos_recovery"
    if e.get("trace") == "burst":
        return f"serving_burst_t{e['tenants']}_s{e['slots']}"
    return (f"serving_t{e['tenants']}_c{e['classes']}_s{e['slots']}"
            + ("" if e["matching_backend"] == "default"
               else f"_{e['matching_backend']}"))


def _row_derived(e: dict) -> str:
    if "megakernel_speedup_pct" in e:
        return (f"speedup={e['megakernel_speedup_pct']}%,"
                f"compose={e['compose_us_per_request']}us,"
                f"mega={e['mega_us_per_request']}us")
    if "telemetry_overhead_pct" in e:
        return (f"overhead={e['telemetry_overhead_pct']}%,"
                f"base={e['base_us_per_request']}us,"
                f"tel={e['telemetry_us_per_request']}us")
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
