"""Quickstart: the hybrid edge classifier end to end, on the port.

Trains the paper's tinyML student CNN (Fig. 5) on the synthetic CIFAR-10
substitute, distils templates, programs the ACAM back end, serves it behind
the declarative front door and reports the accuracy and energy of §V. Twin
of the JAX package's `examples/quickstart.py`; it runs on the card unless
``--device cpu`` asks for the CPU.

    python -m repro_torch.examples.quickstart [--fast] [--mc N] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import match
from repro_torch.core import acam, energy, hybrid
from repro_torch.data import synthetic
from repro_torch.device import resolve
from repro_torch.models import cnn
from repro_torch.train import cnn_trainer as T


def _stats(accs: torch.Tensor) -> str:
    return (f"{float(accs.mean()):.4f} +/- "
            f"{float(accs.std(correction=0)):.4f}")


def main(argv=None, *, device=None) -> dict:
    """Run the quickstart; returns its numbers (accuracies, service
    metrics, energy lines)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--n-per-class", type=int, default=None)
    ap.add_argument("--mc", type=int, default=0, metavar="N",
                    help="Monte-Carlo sweep: N independent sigma_program "
                         "draws (engine.sweep_program_noise) -> confidence "
                         "interval on noisy-hardware accuracy")
    ap.add_argument("--device", default=device,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    T.deterministic_cublas()
    dev = resolve(args.device)
    n = args.n_per_class or (120 if args.fast else 400)
    epochs = 2 if args.fast else 4
    out: dict = {"device": str(dev)}

    print("== data: synthetic CIFAR-10 (greyscale, normalised; paper §IV-A)")
    tr = synthetic.load("train", n_per_class=n, seed=0)
    te = synthetic.load("test", n_per_class=max(n // 4, 50), seed=0)
    gtr = synthetic.normalize(synthetic.to_grayscale(tr.images))
    gte = synthetic.normalize(synthetic.to_grayscale(te.images))
    y_te = torch.as_tensor(te.labels, device=dev)

    print("== front-end: student CNN (conv 32-128-256-16 -> 784 features)")
    cfg = T.TrainConfig(epochs=epochs, batch_size=128)
    params, _ = T.train_student(gtr, tr.labels, cfg=cfg, device=dev)
    acc_soft = T.evaluate(cnn.student_logits, params, gte, te.labels)
    out["softmax_accuracy"] = acc_soft
    print(f"   softmax-head accuracy: {acc_soft:.4f}")

    print("== back-end: binary templates -> TXL-ACAM pattern matching")
    head = hybrid.fit_acam_head(cnn.student_features, params, gtr, tr.labels,
                                10, k=1, device=dev)
    clf = hybrid.HybridClassifier(params, cnn.student_features, head,
                                  device=dev)
    acc_acam = clf.accuracy(gte, te.labels)
    out["acam_accuracy"] = acc_acam
    print(f"   ACAM feature-count accuracy: {acc_acam:.4f} "
          f"(drop {acc_soft - acc_acam:+.4f} vs softmax — paper saw -11%)")

    print("== device physics: the same head through the RRAM-CMOS models")
    with torch.no_grad():
        feats_te = cnn.student_features(params, gte)

    def device_acc(sigma):
        eng = match.engine_for(
            backend="device",
            device=acam.ACAMConfig(sigma_program=sigma), seed=7)
        pred, _ = eng.classify_features(feats_te, head.bank)
        return float((pred == y_te).to(torch.float32).mean())

    ideal, noisy = device_acc(0.0), device_acc(0.10)
    out["device_accuracy"] = {0.0: ideal, 0.10: noisy}
    print(f"   ideal array (sigma=0)      : {ideal:.4f} "
          "(matches the window model exactly)")
    print(f"   noisy RRAM (sigma=0.10)    : {noisy:.4f} "
          "(programming variability, §III)")

    if args.mc > 0:
        # one programmed array is a single sample of the write-noise
        # process; the sweep turns it into a confidence interval
        out["mc"] = {}
        for sigma in (0.05, 0.10, 0.20):
            eng = match.engine_for(
                backend="device",
                device=acam.ACAMConfig(sigma_program=sigma), seed=7)
            preds, _ = eng.sweep_program_noise(feats_te, head.bank, args.mc,
                                               device=dev)
            accs = (preds == y_te[None, :]).to(torch.float32).mean(dim=1)
            out["mc"][sigma] = accs.tolist()
            print(f"   MC x{args.mc} sigma={sigma:.2f}      : {_stats(accs)} "
                  f"(min {float(accs.min()):.4f}, "
                  f"max {float(accs.max()):.4f})")
        # tiled deployments program one physical array PER bank shard
        # (device_noise="per_shard": array s keyed fold_in(seed, s)), a
        # distinct noise layout from the single-array draw above
        eng = match.engine_for(
            backend="device", device=acam.ACAMConfig(sigma_program=0.10),
            seed=7, device_noise="per_shard")
        preds, _ = eng.sweep_program_noise(feats_te, head.bank, args.mc,
                                           bank_shards=2, device=dev)
        accs = (preds == y_te[None, :]).to(torch.float32).mean(dim=1)
        out["mc_per_shard"] = accs.tolist()
        print(f"   MC x{args.mc} sigma=0.10 x2arr: {_stats(accs)} "
              "(per-shard programming keys, 2 arrays)")

    print("== serving: the same head behind the declarative front door")
    # ONE ServiceSpec stands up the whole serving stack (registry ->
    # scheduler -> cascade); the spec round-trips through JSON, so this
    # configuration can ship as a file (launch.serve --spec)
    from repro_torch.match.config import EngineConfig
    from repro_torch.serve import acam_service as svc_lib
    from repro_torch.serve import spec as spec_lib
    from repro_torch.serve.control import HybridService

    spec = spec_lib.ServiceSpec(
        registry=spec_lib.RegistrySpec(num_features=head.bank.num_features),
        engine=EngineConfig(backend=match.default_backend(), margin=True),
        mesh=spec_lib.MeshSpec(bank_shards=1, install=False),
        scheduler=spec_lib.SchedulerSpec(slots=64),
        cascade=spec_lib.CascadeSpec(tau=8.0, tau_units="count"),
    )
    if spec_lib.ServiceSpec.from_json(spec.to_json()) != spec:
        raise RuntimeError("the ServiceSpec does not round-trip")
    svc = HybridService.from_spec(spec, device=dev)
    svc.register_tenant("wearable-0", head.bank,
                        head=(params.head.weight.detach().T.cpu().numpy(),
                              params.head.bias.detach().cpu().numpy()))
    responses = svc.serve([svc_lib.ClassifyRequest("wearable-0", f)
                           for f in feats_te.cpu().numpy()])
    m = svc.metrics()
    acc_svc = float(np.mean([r.pred == y
                             for r, y in zip(responses, te.labels)]))
    out["service"] = dict(accuracy=acc_svc, **{
        key: m[key] for key in ("completed", "classify_dispatches",
                                "escalation_rate", "nj_per_request",
                                "latency_p50_ms", "latency_p99_ms")})
    print(f"   cascade accuracy {acc_svc:.4f} over {m['completed']} requests "
          f"({m['classify_dispatches']} fused dispatches, escalation rate "
          f"{m['escalation_rate']:.3f}, {m['nj_per_request']:.2f} nJ/req)")

    print("== telemetry: the flight recorder behind metrics()")
    # every number above is a view over `svc.obs` (repro_torch.obs): the
    # latency quantiles are exact reads of ONE histogram's buckets, the
    # energy ledger is bit-exact with the per-response sum, and span
    # conservation (started == finished + in-flight) holds by structure
    fleet = svc.obs.ledger.fleet()
    spans = svc.obs.spans.conservation()
    total_j = 0.0  # left to right, as the ledger adds (Python's `sum` of
    for r in responses:  # floats compensates its rounding since 3.12)
        total_j += r.energy_j
    if fleet["total_nj"] != total_j * 1e9:
        raise RuntimeError("the energy ledger disagrees with the responses")
    if spans["started"] != spans["finished"] + spans["in_flight"]:
        raise RuntimeError(f"span conservation broken: {spans}")
    out["ledger_total_nj"] = fleet["total_nj"]
    out["spans"] = spans
    print(f"   energy ledger: {fleet['total_nj']:.1f} nJ over "
          f"{fleet['requests']} requests (backend share "
          f"{fleet['backend_share']:.3f}; bit-exact with per-response sum)")
    print(f"   latency p50/p99: {m['latency_p50_ms']:.3f}/"
          f"{m['latency_p99_ms']:.3f} ms (exact from histogram buckets)")
    print(f"   spans: {spans['started']} started == {spans['finished']} "
          f"finished + {spans['in_flight']} in-flight "
          f"(dispositions {spans['by_disposition']})")

    print("== energy (paper §V-D arithmetic)")
    nums = energy.paper_numbers()
    out["energy"] = dict(nums, head_nj=head.energy_per_inference() * 1e9)
    print(f"   back-end  : {nums['backend_nj']:.2f} nJ / inference (Eq. 14)")
    print(f"   front-end : {nums['frontend_nj']:.2f} nJ / inference")
    print(f"   teacher   : {nums['teacher_uj']:.2f} uJ / inference")
    print(f"   reduction : {nums['reduction_x']:.0f}x")
    print(f"   this head : {out['energy']['head_nj']:.2f} nJ")
    return out


if __name__ == "__main__":
    main()
