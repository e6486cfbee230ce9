"""Batched serving demo of the port: the multi-tenant ACAM service.

Trains the paper's CNN front end, fits its ACAM template bank, registers it
as a tenant of the service (alongside ``--tenants - 1`` synthetic ones), and
classifies the test set through it: micro-batched cross-tenant scheduling,
one matching kernel call per tick, confidence-cascade escalation to the
CNN's dense head and §V-D energy per request. Twin of the ``acam`` workload
of the JAX package's `examples/serve_batched.py`; the ``lm`` workload comes
with the LM slice of the port. Runs on the card unless ``--device cpu``
asks for the CPU.

    python -m repro_torch.examples.serve_batched --workload acam --fast
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def run_acam(args, device=None) -> dict:
    """Train, fit, serve; returns the service metrics with the accuracy
    against the labels."""
    from repro_torch import match
    from repro_torch.core import hybrid
    from repro_torch.data import synthetic
    from repro_torch.device import resolve
    from repro_torch.match.config import EngineConfig
    from repro_torch.models import cnn
    from repro_torch.serve import acam_service as svc_lib
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.control import HybridService
    from repro_torch.train import cnn_trainer as T

    T.deterministic_cublas()
    dev = resolve(device)
    n = 80 if args.fast else 200
    tr = synthetic.load("train", n_per_class=n, seed=0)
    gtr = synthetic.normalize(synthetic.to_grayscale(tr.images))
    cfg = T.TrainConfig(epochs=1 if args.fast else 2, batch_size=128)
    params, _ = T.train_student(gtr, tr.labels, cfg=cfg, device=dev)
    head = hybrid.fit_acam_head(cnn.student_features, params, gtr,
                                tr.labels, 10, k=1, device=dev)

    # the trained hybrid classifier is tenant 0, its dense softmax head the
    # escalation target; --tenants adds synthetic co-tenants so the
    # scheduler coalesces
    spec = spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(
            num_features=head.bank.num_features),
        engine=EngineConfig(backend=args.backend or match.default_backend(),
                            margin=True),
        mesh=spec_lib.MeshSpec(bank_shards=1, install=False),
        scheduler=spec_lib.SchedulerSpec(slots=args.batch_size),
        cascade=spec_lib.CascadeSpec(tau=args.margin_tau,
                                     tau_units="count"),
    )
    svc = HybridService.from_spec(spec, device=dev)
    dense = params.head
    svc.register_tenant(
        "wearable-0", head.bank,
        head=(dense.weight.detach().cpu().numpy().T.copy(),
              dense.bias.detach().cpu().numpy()))
    protos = {}
    for t in range(1, args.tenants):
        bank, thead, p = svc_lib.make_synthetic_tenant(
            1000 + t, num_classes=10, num_features=head.bank.num_features)
        svc.register_tenant(f"synthetic-{t}", bank, head=thead)
        protos[f"synthetic-{t}"] = p

    # the front end runs batched; the service serves the (features ->
    # class) back end per request
    te = synthetic.load("test", n_per_class=max(n // 4, 25), seed=1)
    gte = synthetic.normalize(synthetic.to_grayscale(te.images))
    feats = cnn.student_features(params, gte).cpu().numpy()

    rng = np.random.RandomState(0)
    reqs, truth = [], []
    for i in rng.permutation(len(te.labels)):
        reqs.append(svc_lib.ClassifyRequest("wearable-0", feats[i]))
        truth.append(int(te.labels[i]))
    for tid, p in protos.items():
        qf, qy = svc_lib.sample_tenant_queries(11, p, len(te.labels) // 4)
        for i in range(len(qy)):
            reqs.append(svc_lib.ClassifyRequest(tid, qf[i]))
            truth.append(int(qy[i]))
    if args.tenants > 1:  # interleave so micro-batches mix tenants
        order = rng.permutation(len(reqs))
        reqs = [reqs[i] for i in order]
        truth = [truth[i] for i in order]

    t0 = time.time()
    responses = svc.serve(reqs)
    dt = time.time() - t0
    m = svc.metrics()
    correct = sum(r.pred == y for r, y in zip(responses, truth))
    acc = correct / len(responses)
    print(f"acam workload: {m['completed']} classifications over "
          f"{max(args.tenants, 1)} tenants in {dt:.2f}s "
          f"({m['completed'] / dt:.0f} req/s), accuracy {acc:.4f}")
    print(f"  scheduler: {m['classify_dispatches']} fused dispatches, "
          f"occupancy {m['occupancy']:.2f} "
          f"(fill {m['min_fill']}..{m['max_fill']} of {m['slots']} slots)")
    print(f"  cascade: escalation rate {m['escalation_rate']:.3f}, "
          f"{m['nj_per_request']:.2f} nJ/request (accepted-at-ACAM backend "
          f"energy {head.energy_per_inference() * 1e9:.2f} nJ, paper Eq. 14)")
    return {"accuracy": acc, **m}


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("lm", "acam"), default="acam")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--tenants", type=int, default=3,
                    help="acam: total tenants (1 trained + N-1 synthetic)")
    ap.add_argument("--margin-tau", type=float, default=8.0,
                    help="acam: cascade accept threshold (match counts)")
    ap.add_argument("--backend", default=None,
                    choices=("auto", "kernel", "reference", "device"),
                    help="acam: repro_torch.match engine backend "
                         "(device = RRAM-CMOS physics models)")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.workload == "lm":
        raise NotImplementedError(
            "--workload lm: the LM decode workload comes with the LM slice "
            "of the port")
    return run_acam(args, device=args.device)


if __name__ == "__main__":
    main()
