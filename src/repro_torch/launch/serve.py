"""Serving launcher of the port: the LM decode engine, the multi-tenant
ACAM service, or the two composed.

The flag surface is the JAX package's `repro.launch.serve`. Every workload
runs on the card unless the caller asks for the CPU
(``main(argv, device="cpu")``; the command line always means the card):

  lm         batched generation over the LM zoo
             (`repro_torch.serve.engine.Engine`) with seeded random
             weights; ``--smoke`` (the default, as in the JAX launcher)
             takes the architecture's SMOKE config, and a caller that builds
             the args itself reaches full width with ``args.smoke = False``.
  acam       the multi-tenant hybrid-classifier service, built through ONE
             declarative `repro_torch.serve.spec.ServiceSpec` (from the
             flags, or verbatim from ``--spec service.json``) handed to
             `HybridService.from_spec`.
  lm-cached  the two composed (`repro_torch.serve.semantic_cache`): the
             ACAM tier fronts the decode engine as a template router.

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 8
  python -m repro_torch.launch.serve --workload lm-cached --requests 32 \
      --unique 8
  python -m repro_torch.launch.serve --workload acam --spec service.json
  python -m repro_torch.launch.serve --workload acam --tenants 8 \
      --requests 256 --slots 64 --print-spec
  python -m repro_torch.launch.serve --workload acam \
      --backend device   # serve through the RRAM-CMOS physics models

Under ``--backend device`` the served margins are matchline fractions and
the spec rescales the count-unit ``--margin-tau`` by 1/N itself
(`ServiceSpec.tau_scale`); ``--device-noise`` picks the programming-noise
semantics. ``--manifest FILE.json`` populates the tenants from a
`repro_torch.fleet.FleetManifest` (``apply_manifest``), ``--autopilot``
serves through the fleet autopilot (one ``observe_tick`` per step, in
bursts of ``slots`` requests), ``--snapshot-dir DIR`` snapshots the service
after serving, and ``--snapshot-dir DIR --restore`` boots from the latest
snapshot there (a restart serves what the first run would have):

  python -m repro_torch.launch.serve --workload acam --snapshot-dir ckpt
  python -m repro_torch.launch.serve --workload acam --snapshot-dir ckpt \
      --restore

``--bank-shards N`` shards the super-bank's class rows over a model mesh
axis of N devices, installed through the spec (`HybridService.from_spec`).
N must divide the devices of `repro_torch.distributed.context.devices()`:
on one card (or the CPU) that takes a forced mesh, whose N shards then run
in turn on the one device; without one, ``--bank-shards 2`` raises the
JAX launcher's `ValueError`:

  REPRO_FORCE_MESH=1x2 python -m repro_torch.launch.serve --workload acam \
      --bank-shards 2
``--profile-annotations`` marks each fused dispatch with
`repro_torch.obs.span`, which records a `torch.profiler.record_function`
range only while a profiler is recording.
"""
from __future__ import annotations

import argparse

import numpy as np


def build_acam_spec(args):
    """The launcher's flag surface -> one `ServiceSpec` (or load the spec
    verbatim from ``--spec file.json`` — flags are then ignored)."""
    from repro_torch import match as match_lib
    from repro_torch.match.config import EngineConfig
    from repro_torch.serve import spec as spec_lib

    if args.spec:
        return spec_lib.ServiceSpec.from_file(args.spec)
    return spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(
            num_features=args.features,
            initial_classes=spec_lib.aligned_classes(args.bank_shards)),
        engine=EngineConfig(backend=args.backend
                            or match_lib.default_backend(), margin=True,
                            device_noise=args.device_noise),
        mesh=spec_lib.MeshSpec(bank_shards=args.bank_shards),
        scheduler=spec_lib.SchedulerSpec(slots=args.slots),
        cascade=spec_lib.CascadeSpec(tau=args.margin_tau,
                                     tau_units="count",
                                     deadline_ms=args.deadline_ms,
                                     shed_queue=args.shed_queue),
        obs=spec_lib.ObsSpec(telemetry_dir=args.telemetry_dir,
                             span_sample=args.span_sample,
                             profile_annotations=args.profile_annotations),
    )


def run_lm(args, device=None, cfg=None) -> dict:
    """Seeded random weights for ``--arch`` (or for ``cfg``, a caller's
    `ArchConfig`, e.g. a full-width config cut in depth) on ``device``,
    ``--requests`` prompts of 4-31 tokens, one `Engine.generate`. Returns
    the token count and wall time, with the requests and the engine."""
    import time

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = cfg or configs.get(args.arch, smoke=args.smoke)
    params = lm.init_params(args.seed, cfg, device=device)
    eng = Engine(cfg, params, batch_size=args.batch_size,
                 max_len=args.max_len, temperature=args.temperature)
    rng = np.random.RandomState(args.seed)
    reqs = [Request(prompt=rng.randint(0, cfg.vocab, size=rng.randint(4, 32)),
                    max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    t0 = time.time()
    eng.generate(reqs)
    dt = time.time() - t0
    total = sum(len(r.out) for r in reqs)
    print(f"{cfg.name}: {len(reqs)} requests, {total} tokens, "
          f"{dt:.2f}s ({total / dt:.1f} tok/s)")
    return {"tokens": total, "seconds": dt, "requests": reqs, "engine": eng}


def run_lm_cached(args, device=None) -> dict:
    """The two engines composed: the ACAM semantic cache in front of LM
    decode. A Zipf-repeat prompt trace is routed through
    `SemanticCacheService`: repeats of an admitted prompt answer from the
    response store at Eq. 14 ACAM energy, cold prompts escalate to ONE
    `Engine.generate` call per tick and are admitted back as templates.
    Returns the hit count, the served count and the service metrics, with
    the responses and the service."""
    import time

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.semantic_cache import (PromptRequest,
                                                  SemanticCacheService,
                                                  synthetic_prompt_trace)

    cfg = configs.get(args.arch, smoke=args.smoke)
    params = lm.init_params(args.seed, cfg, device=device)
    eng = Engine(cfg, params, batch_size=args.batch_size,
                 max_len=args.max_len, temperature=args.temperature,
                 seed=args.seed)
    spec = spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(num_features=args.features),
        scheduler=spec_lib.SchedulerSpec(slots=args.slots),
        cascade=spec_lib.CascadeSpec(backend="lm", tau=args.margin_tau,
                                     tau_units="count"),
        router=spec_lib.RouterSpec(max_templates=max(args.unique, 1)),
        mesh=spec_lib.MeshSpec(install=False))
    if args.print_spec:
        print(spec.to_json())
    svc = SemanticCacheService.from_spec(spec, engine=eng, device=device)
    svc.add_tenant("edge-0")

    trace = synthetic_prompt_trace(args.seed, vocab=cfg.vocab,
                                   n_unique=args.unique,
                                   n_requests=args.requests)
    # arrivals come in bursts: a template admitted on a miss serves hits
    # only on LATER ticks
    burst = max(1, min(args.slots, args.unique))
    t0 = time.time()
    out = []
    for i in range(0, len(trace), burst):
        out.extend(svc.serve_prompts(
            PromptRequest("edge-0", p, max_new_tokens=args.max_new)
            for p in trace[i:i + burst]))
    dt = time.time() - t0
    m = svc.metrics()
    hits = sum(r.cache_hit for r in out)
    served = sum(r.error is None for r in out)
    fleet = svc.obs.ledger.fleet()
    print(f"{cfg.name} behind ACAM semantic cache: {served} requests "
          f"({args.unique} unique), {hits} cache hits "
          f"({hits / max(served, 1):.2f} hit rate), "
          f"{m['classify_dispatches']} fused match dispatches over "
          f"{m['ticks']} ticks, {dt:.2f}s")
    print(f"  energy: {m['nj_per_request']:.1f} nJ/request mean "
          f"(ACAM share {fleet['backend_share']:.4f}; decode misses carry "
          f"{fleet['frontend_nj']:.1f} nJ of the "
          f"{fleet['total_nj']:.1f} nJ total)")
    return {"hits": hits, "served": served, "seconds": dt, **m,
            "responses": out, "service": svc}


def run_acam(args, device=None) -> dict:
    """Boot the service from the spec, register the synthetic tenants,
    serve the request stream, print the metrics. Returns the metrics with
    the accuracy against the sampled labels, the responses in request
    order (``"responses"``) and the autopilot's action log
    (``"autopilot"``, None without ``--autopilot``)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.serve import acam_service as svc_lib
    from repro_torch.serve.control import HybridService

    spec = build_acam_spec(args)
    if args.print_spec:
        print(spec.to_json())
    if args.restore:
        if not args.snapshot_dir:
            raise SystemExit("--restore needs --snapshot-dir")
        svc, report = HybridService.restore(Checkpointer(args.snapshot_dir),
                                            device=device)
        print(f"restored step {report.step}: {report.tenants} tenants, "
              f"{report.restore_s * 1e3:.1f} ms"
              + (" (resharded)" if report.resharded else ""))
        spec = svc.spec
    else:
        svc = HybridService.from_spec(spec, device=device)
    n_features = spec.registry.num_features
    if spec.mesh.bank_shards > 1:
        from repro_torch.distributed import context

        print(f"installed serving mesh model={spec.mesh.bank_shards} "
              f"({len(context.devices(svc.device))} devices)")

    protos = {}
    if args.manifest:
        # the tenant population from ONE FleetManifest file, diffed
        # against the (empty) manifest in force
        from repro_torch.fleet import FleetManifest

        rep = svc.apply_manifest(FleetManifest.from_file(args.manifest))
        print(f"manifest applied: +{len(rep.added)} added, "
              f"-{len(rep.evicted)} evicted, {len(rep.updated)} updated, "
              f"{len(rep.retuned)} retuned "
              f"({len(svc.registry)} tenants live)")
        for t in rep.manifest.tenants:
            if t.seed is not None:  # checkpoint tenants have no protos
                protos[t.tenant_id] = svc_lib.make_synthetic_tenant(
                    t.seed, num_classes=t.num_classes, k=t.k,
                    num_features=n_features)[2]
    else:
        for t in range(args.tenants):
            bank, head, p = svc_lib.make_synthetic_tenant(
                args.seed * 1000 + t, num_classes=args.classes,
                num_features=n_features)
            tid = f"tenant-{t}"
            if tid not in svc.registry:  # a restored service adopted them
                svc.register_tenant(tid, bank, head=head)
            protos[tid] = p

    # mixed-tenant request stream (round-robin interleave, then shuffled —
    # every micro-batch holds several tenants)
    rng = np.random.RandomState(args.seed)
    reqs, truth = [], []
    tids = sorted(protos)
    per_tenant = -(-args.requests // max(len(tids), 1))
    for t, tid in enumerate(tids):
        feats, labels = svc_lib.sample_tenant_queries(
            args.seed + 7 * t, protos[tid], per_tenant, noise=args.noise)
        for i in range(per_tenant):
            reqs.append(svc_lib.ClassifyRequest(tid, feats[i]))
            truth.append(int(labels[i]))
    order = rng.permutation(len(reqs))[:args.requests]
    reqs = [reqs[i] for i in order]
    truth = [truth[i] for i in order]

    if args.autopilot:
        # closed-loop serving: bursty submission, one observe_tick per
        # step; the policy may widen slots, swap backends or compact
        from repro_torch.fleet import Autopilot, PolicySpec

        pilot = Autopilot(svc, policy=PolicySpec())
        burst = spec.scheduler.slots
        responses, i = [], 0
        while i < len(reqs) or svc.scheduler.qsize:
            for r in reqs[i:i + burst]:
                svc.submit(r)
            i += burst
            responses.extend(svc.step())
            pilot.observe_tick()
            responses.extend(pilot.take_drained())
        if pilot.actions:
            acts = ", ".join(f"t{a['tick']}:{a['action']}"
                             for a in pilot.actions)
            print(f"autopilot: {len(pilot.actions)} actions ({acts}); "
                  f"now slots={svc.spec.scheduler.slots}, "
                  f"backend={svc.spec.engine.backend}")
        else:
            print("autopilot: no action (no threshold crossed)")
        spec = svc.spec
    else:
        responses = svc.serve(reqs)
    m = svc.metrics()
    if args.snapshot_dir:
        step = svc.snapshot(Checkpointer(args.snapshot_dir))
        print(f"service snapshot -> {args.snapshot_dir} step {step} "
              f"(restart with --restore)")
    acc = float(np.mean([r.pred == y for r, y in zip(responses, truth)]))
    print(f"acam service: {m['completed']} requests over "
          f"{len(svc.registry)} tenants, "
          f"{m['classify_dispatches']} fused dispatches "
          f"(occupancy {m['occupancy']:.2f}), accuracy {acc:.4f}")
    print(f"  escalation rate {m['escalation_rate']:.3f} "
          f"({m['escalated']} escalated, "
          f"{m['escalation_dispatches']} head dispatches), "
          f"{m['nj_per_request']:.2f} nJ/request, "
          f"{m['requests_per_s']:.1f} req/s, "
          f"p50 {m['latency_p50_ms']:.1f} ms / p99 {m['latency_p99_ms']:.1f} ms")
    fleet = svc.obs.ledger.fleet()
    print(f"  energy ledger: {fleet['total_nj']:.1f} nJ fleet total, "
          f"backend share {fleet['backend_share']:.3f} "
          f"(E_backend {fleet['backend_nj']:.1f} nJ / "
          f"E_frontend {fleet['frontend_nj']:.1f} nJ)")
    if spec.obs.telemetry_dir:
        import os

        from repro_torch.obs import write_prometheus

        prom = os.path.join(spec.obs.telemetry_dir, "metrics.prom")
        write_prometheus(svc.obs.registry, prom)
        print(f"  telemetry: {svc.obs.events.path} (event log), "
              f"{prom} (Prometheus scrape)")
    return {"accuracy": acc, **m, "responses": responses,
            "autopilot": pilot.actions if args.autopilot else None}


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX launcher's flags, with ``--requests`` defaulted per
    workload. A caller that builds the args itself may change them before
    calling a ``run_*`` (``args.smoke = False`` for full width)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=("lm", "acam", "lm-cached"),
                    default="lm")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    # lm
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    # lm-cached
    ap.add_argument("--unique", type=int, default=8,
                    help="lm-cached: distinct prompts in the Zipf trace "
                         "(the rest are cache-hitting repeats)")
    # acam
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="boot the acam service from a declarative "
                         "ServiceSpec JSON file (other acam flags ignored)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved ServiceSpec JSON before boot")
    ap.add_argument("--manifest", default=None, metavar="FILE.json",
                    help="populate tenants from a declarative FleetManifest "
                         "JSON file")
    ap.add_argument("--autopilot", action="store_true",
                    help="drive serving through the fleet autopilot")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--classes", type=int, default=10,
                    help="classes per synthetic tenant")
    ap.add_argument("--features", type=int, default=64,
                    help="feature dim of the synthetic tenants")
    ap.add_argument("--margin-tau", type=float, default=8.0,
                    help="cascade accept threshold (match-count units)")
    ap.add_argument("--noise", type=float, default=0.8,
                    help="query noise (drives the escalation rate)")
    ap.add_argument("--backend", default=None,
                    choices=("auto", "kernel", "reference", "device"),
                    help="repro_torch.match engine backend for the ACAM "
                         "service (device: the RRAM-CMOS physics models); "
                         "default: REPRO_MATCHING_BACKEND / auto")
    ap.add_argument("--bank-shards", type=int, default=1,
                    help="shard the template super-bank's class rows over "
                         "a model mesh axis of this size (must divide the "
                         "device count; on one card set REPRO_FORCE_MESH)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="snapshot the service into DIR after serving")
    ap.add_argument("--restore", action="store_true",
                    help="boot by restoring the latest snapshot from "
                         "--snapshot-dir")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request queue deadline: requests older than "
                         "this at tick time are expired with an error")
    ap.add_argument("--shed-queue", type=int, default=None,
                    help="queue depth at which the service enters load-shed "
                         "mode (ACAM stage alone, no CNN escalation)")
    ap.add_argument("--telemetry-dir", default=None, metavar="DIR",
                    help="flight-recorder sinks: append a JSONL event log "
                         "(DIR/events.jsonl) and write a Prometheus scrape "
                         "file (DIR/metrics.prom) after serving")
    ap.add_argument("--span-sample", type=float, default=1.0,
                    help="fraction of requests carrying a full per-request "
                         "span (deterministic in the request id)")
    ap.add_argument("--profile-annotations", action="store_true",
                    help="wrap the fused dispatch in repro_torch.obs.span: "
                         "a torch.profiler.record_function range while a "
                         "profiler is recording")
    ap.add_argument("--device-noise", default="global",
                    choices=("global", "per_shard"),
                    help="sigma_program noise semantics of the device "
                         "backend (carried in the spec)")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = {"lm": 8, "acam": 256, "lm-cached": 32}[args.workload]
    return args


def main(argv=None, *, device=None) -> dict:
    """Parse the JAX launcher's flags and run the workload on ``device``
    (the card unless the caller asks for the CPU)."""
    args = parse_args(argv)
    runner = {"lm": run_lm, "acam": run_acam,
              "lm-cached": run_lm_cached}[args.workload]
    return runner(args, device=device)


if __name__ == "__main__":
    main()
