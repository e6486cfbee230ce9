"""Serving launcher of the port: the multi-tenant ACAM service.

The flag surface is the JAX package's `repro.launch.serve`. The ``acam``
workload builds the service through ONE declarative
`repro_torch.serve.spec.ServiceSpec` (from the flags, or verbatim from
``--spec service.json``) handed to `HybridService.from_spec`, registers
synthetic tenants, serves a mixed-tenant request stream and prints the
service metrics. It runs on the card unless the caller asks for the CPU
(``main(argv, device="cpu")``; the command line always means the card):

  python -m repro_torch.launch.serve --workload acam --spec service.json
  python -m repro_torch.launch.serve --workload acam --tenants 8 \\
      --requests 256 --slots 64 --print-spec
  python -m repro_torch.launch.serve --workload acam \\
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

Not in the port yet, each raising `NotImplementedError`: the ``lm`` and
``lm-cached`` workloads (the LM slice) and ``--bank-shards > 1`` (the
multi-GPU slice). ``--profile-annotations`` marks each fused dispatch with
`torch.profiler.record_function`.
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


def _unported(args) -> None:
    """Raise for the flags whose machinery comes with a later slice."""
    later = {
        "lm": "the LM decode workload comes with the LM slice of the port",
        "lm-cached": "the LM semantic-cache workload comes with the LM slice "
                     "of the port",
    }
    if args.workload in later:
        raise NotImplementedError(f"--workload {args.workload}: "
                                  f"{later[args.workload]}")
    if args.bank_shards > 1:
        raise NotImplementedError(
            f"--bank-shards {args.bank_shards}: sharding the super-bank "
            "over several cards comes with the multi-GPU slice of the port")


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
              f"{report.restore_s * 1e3:.1f} ms")
        spec = svc.spec
    else:
        svc = HybridService.from_spec(spec, device=device)
    n_features = spec.registry.num_features

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


def main(argv=None, *, device=None) -> dict:
    """Parse the JAX launcher's flags and run the workload on ``device``
    (the card unless the caller asks for the CPU)."""
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
                         "this many cards (only 1 in the port yet)")
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
                    help="wrap the fused dispatch in a "
                         "torch.profiler.record_function range")
    ap.add_argument("--device-noise", default="global",
                    choices=("global", "per_shard"),
                    help="sigma_program noise semantics of the device "
                         "backend (carried in the spec)")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = {"lm": 8, "acam": 256, "lm-cached": 32}[args.workload]
    _unported(args)
    return run_acam(args, device=device)


if __name__ == "__main__":
    main()
