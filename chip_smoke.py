#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py [--report PATH]   # on a machine with a CUDA card

Builds the CUDA kernels from `src/repro_torch/csrc/` and drives the port on
one CUDA card, with no JAX:

 1. kernels   B1-B4 against their plain PyTorch versions on the card, at the
              shapes the main paths give them plus ragged, empty-window,
              all-invalid, tie and flush-to-zero probes; all bit-identical.
              Times (CUDA events, median of 60 after warm-up): the kernel,
              the plain version, and the bipolar `torch.matmul` score
              product alone (a partial yardstick: it computes only the
              kernel's product).
 2. paths     each main path driven through the entry points a user calls,
              with the launch counts set to 0 just before and read just
              after: `HybridClassifier.predict` (B1) at paper width (the
              Fig. 5 student, 32x32x1 -> 784 features, 10 classes), the
              multi-tenant `HybridService` tick (B3; 8 tenants x 10
              classes, 64 slots, tau 8 counts), the same service under
              ``serve_fusion="compose"`` (B4), and
              `MatchEngine.classify_features` on a bank past
              `MAX_FUSED_ROWS` (B2). The served answers must equal the
              compose tick's and those of the same service on the CPU,
              where each kernel runs its plain version.
 3. report    the card's name and power limit, metrics and the energy
              split, one ``{"kernels": [...]}`` line, and as the last line
              ``{"ok": true, "device": {...}}``. ``--report PATH``
              also writes every measurement to PATH as JSON.

Every failed check raises, so the run exits non-zero. Without a CUDA card,
or without the repository beside it, it exits non-zero before any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/csrc/acam_match.cu"
TPU_SITE = "src/repro/kernels/acam_match/acam_match.py"
# kernel -> line of the TPU kernel's pallas_call in TPU_SITE (B1, B4, B2, B3)
PALLAS_LINE = {
    "acam_match_classify": 204,
    "acam_match_classify_margins": 302,
    "acam_match_classify_margins_chunked": 418,
    "acam_match_serve": 575,
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor rate
N = 784  # Fig. 5 features
ITERS = 60


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, iters: int = ITERS) -> float:
    """Median per-call time with CUDA events (host launch cost included)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def profile(fn, reps: int = 1) -> dict:
    """`torch.profiler` over ``reps`` calls of ``fn`` (after one warm-up),
    per call: wall time, summed device time of every kernel and copy, the
    device's idle share of the wall time, and the device time per kernel
    name (top 8). Device times are None when the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_name = {}
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if dt > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 1e3 / reps
    busy = sum(by_name.values())
    return dict(wall_ms=wall_ms, device_ms=busy or None,
                idle_share=1 - busy / wall_ms if busy else None,
                by_kernel=dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:8]))


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------

def case(seed: int, b: int, c: int, k: int, n: int, device, *,
         t_rows: int = 8):
    """Random operands of one call: features, thresholds, a (C, K, N) {0,1}
    bank with ~80% valid rows, per-row windows (row 0 empty), tenant slots,
    and a thresholds table."""
    import torch

    rng = np.random.default_rng(seed)

    def dev(x):
        return torch.as_tensor(x, device=device)

    lo = rng.integers(0, max(c - 4, 1), size=b)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c)
    hi[0] = lo[0]
    return dict(
        f=dev(rng.standard_normal((b, n), dtype=np.float32)),
        thr=dev(rng.standard_normal(n, dtype=np.float32) * 0.1),
        t=dev((rng.random((c, k, n)) > 0.5).astype(np.float32)),
        valid=dev(rng.random((c, k)) > 0.2),
        lo=dev(lo.astype(np.int32)), hi=dev(hi.astype(np.int32)),
        table=dev(rng.standard_normal((t_rows, n), dtype=np.float32) * 0.1),
        slot=dev(rng.integers(0, t_rows, size=b).astype(np.int32)))


def faces(x: dict, c: int, k: int):
    """Each face's (wrapper, plain, args, kwargs) on one case."""
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.match import MAX_FUSED_ROWS

    cp = layout.padded_classes(c)
    chunk = layout.class_chunk(cp, k, MAX_FUSED_ROWS)
    t_km = layout.flatten_kmajor(x["t"], c)
    v_km = layout.valid_kmajor(x["valid"], c)
    t_kcp = layout.stack_kcp(x["t"], c)
    v_kcp = layout.valid_kcp(x["valid"], c)
    margins = am.serve_plain(x["f"], x["table"], x["slot"], t_kcp, v_kcp,
                             x["lo"], x["hi"], torch.zeros_like(x["f"][:, 0]),
                             c, chunk=chunk)[2]
    sign = torch.where(torch.arange(len(margins), device=margins.device) % 2
                       == 0, 0.5, -0.5)
    tau = (margins + sign).to(torch.float32)  # straddles every margin
    return {
        "acam_match_classify": (
            am.acam_match_classify, am.classify_plain,
            (x["f"], x["thr"], t_km, v_km, c), {}),
        "acam_match_classify_margins": (
            am.acam_match_classify_margins, am.classify_margins_plain,
            (x["f"], x["thr"], t_km, v_km, x["lo"], x["hi"], c), {}),
        "acam_match_classify_margins_chunked": (
            am.acam_match_classify_margins_chunked,
            am.classify_margins_chunked_plain,
            (x["f"], x["thr"], t_kcp, v_kcp, x["lo"], x["hi"], c),
            {"chunk": chunk}),
        "acam_match_serve": (
            am.acam_match_serve, am.serve_plain,
            (x["f"], x["table"], x["slot"], t_kcp, v_kcp, x["lo"], x["hi"],
             tau, c), {"chunk": chunk}),
    }


def compare(name: str, got, want) -> float:
    """Bit-identity of every output; returns the max |diff| of the finite
    float outputs (0.0 when identical)."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{name} output {i}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.dtype.is_floating_point:
            both = torch.isfinite(g) & torch.isfinite(w)
            if both.any():
                err = max(err, float((g[both] - w[both]).abs().max()))
        check(torch.equal(g, w), f"{name} output {i} differs from its plain "
              f"version (max |diff| {err})")
    return err


def bound(name: str, b: int, c: int, k: int, n: int, t_rows: int):
    """Least time for the call on an H100 SXM: the bytes it must move (each
    input read once, each output written once; templates counted for the C
    true classes) over 3.35 TB/s, against its B*K*C*N cell matches as two
    int8 operations each over 1,979 TOP/s. Returns (ms, bound_by, bytes)."""
    nbytes = b * n * 4 + k * c * n * 4 + k * c * 4 + b * 4 + b * c * 4
    if name == "acam_match_serve":
        nbytes += t_rows * n * 4 + b * 4 + 2 * b * 4 + b * 4 + b * 4 + b
    else:
        nbytes += n * 4
        if name != "acam_match_classify":
            nbytes += 2 * b * 4 + b * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * b * k * c * n / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def kernel_phase(device) -> dict:
    import torch

    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am

    # (b, c, k, n): main-path shapes first (timed), then edge cases
    main_shapes = {
        "acam_match_classify": (256, 10, 1, N),  # HybridClassifier.predict
        "acam_match_classify_margins": (64, 128, 2, N),  # compose tick
        "acam_match_classify_margins_chunked": (64, 1100, 2, N),  # big bank
        "acam_match_serve": (64, 128, 2, N),  # serving tick
    }
    edge_shapes = [(37, 30, 2, 300), (1, 1, 1, 1), (200, 257, 3, 1000),
                   (16, 12, 4, 64), (16, 1100, 2, 64)]
    out = {}
    for seed, (name, (b, c, k, n)) in enumerate(main_shapes.items()):
        x = case(seed, b, c, k, n, device)
        wrapper, plain, args, kw = faces(x, c, k)[name]
        err = compare(name, wrapper(*args, **kw), plain(*args, **kw))
        q_pm = (x["f"] > x["thr"]).float() * 2 - 1
        t_pm = layout.flatten_kmajor(x["t"], c) * 2 - 1
        ms, by, nbytes = bound(name, b, c, k, n, 8)
        out[name] = dict(
            shape=dict(B=b, C=c, K=k, N=n), max_abs_err=err,
            ms=time_ms(lambda: wrapper(*args, **kw)),
            plain_ms=time_ms(lambda: plain(*args, **kw)),
            library_ms=time_ms(lambda: torch.matmul(q_pm, t_pm.T)),
            bound_ms=ms, bound_by=by, bound_bytes=nbytes,
            profile=profile(lambda: wrapper(*args, **kw), reps=20))
    for seed, (b, c, k, n) in enumerate(edge_shapes):
        x = case(100 + seed, b, c, k, n, device)
        # duplicate templates: exact ties resolve to the lowest class
        if c > 3:
            x["t"][1] = x["t"][0]
            x["valid"][1] = x["valid"][0]
            x["valid"][2] = False  # an all-invalid class
        for name, (wrapper, plain, args, kw) in faces(x, c, k).items():
            out[name]["max_abs_err"] = max(
                out[name]["max_abs_err"],
                compare(f"{name} {b}x{c}x{k}x{n}", wrapper(*args, **kw),
                        plain(*args, **kw)))
    # flush-to-zero probe: f one ulp above thr, at thr ~ 1 and at the
    # smallest normal (there (f - thr) is subnormal; FTZ would zero it)
    for thr_val in (1.0, float(np.finfo(np.float32).tiny)):
        c, k, n = 10, 1, 64
        x = case(7, 8, c, k, n, device, t_rows=1)
        thr = np.full(n, thr_val, np.float32)
        f = np.tile(np.nextafter(thr, np.float32(np.inf)), (8, 1))
        x["f"] = torch.as_tensor(f, device=device)
        x["thr"] = torch.as_tensor(thr, device=device)
        x["table"] = x["thr"][None, :].clone()
        x["slot"].zero_()
        x["t"].fill_(1.0)
        for name, (wrapper, plain, args, kw) in faces(x, c, k).items():
            got = wrapper(*args, **kw)
            compare(f"{name} ftz probe thr={thr_val}", got, plain(*args, **kw))
            best = got[1].max(dim=1).values
            check(bool((best == n).all()), f"{name} flushed a subnormal "
                  f"difference at thr={thr_val}")
    am.reset_launches()
    return out


# ---------------------------------------------------------------------------
# 2. the main paths, through the entry points
# ---------------------------------------------------------------------------

def class_images(rng, protos: np.ndarray, labels: np.ndarray,
                 noise: float) -> np.ndarray:
    return (protos[labels] + noise * rng.standard_normal(
        (len(labels),) + protos.shape[1:])).astype(np.float32)


def drive(name: str, fn, kernels: list[str]):
    """Run one path with the launch counts zeroed just before and read just
    after; every kernel of the path must have launched."""
    from repro_torch.kernels.acam_match import acam_match as am

    am.reset_launches()
    t0 = time.perf_counter()
    result = fn()
    import torch

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(am.LAUNCHES)
    for k in kernels:
        check(counts[k] > 0, f"path {name}: kernel {k} never launched")
    return result, counts, wall


def paths(device, cfg=None, per_class: int = 64) -> dict:
    import torch

    from repro_torch import match
    from repro_torch.core.hybrid import HybridClassifier, fit_acam_head
    from repro_torch.kernels import layout
    from repro_torch.kernels.acam_match import acam_match as am
    from repro_torch.match import EngineConfig
    from repro_torch.models.cnn import StudentConfig, init_student, \
        student_features
    from repro_torch.serve.acam_service import ClassifyRequest
    from repro_torch.serve.control import HybridService
    from repro_torch.serve.spec import (CascadeSpec, RegistrySpec,
                                        SchedulerSpec, ServiceSpec)

    report = {}
    cfg = cfg or StudentConfig()
    n = cfg.num_features
    model = init_student(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)

    # -- HybridClassifier.predict (B1) --------------------------------------
    protos = rng.standard_normal((10, 32, 32, 1)).astype(np.float32)
    cal_y = np.repeat(np.arange(10), per_class)
    cal_x = class_images(rng, protos, cal_y, 0.5)
    head = fit_acam_head(student_features, model, cal_x, cal_y, 10,
                         device=device)
    clf = HybridClassifier(model, student_features, head, device=device)
    test_y = rng.integers(0, 10, 256)
    test_x = class_images(rng, protos, test_y, 0.5)
    pred, counts, wall = drive("predict", lambda: clf.predict(test_x),
                               ["acam_match_classify"])
    check(pred.shape == (256,) and pred.dtype == torch.int32,
          "predict: 256 int32 class ids")
    feats = student_features(model, test_x)
    check(bool(torch.isfinite(feats).all()) and feats.shape == (256, n),
          f"predict: finite (256, {n}) features")
    bank = head.bank
    want, _ = am.classify_plain(feats, bank.thresholds,
                                layout.flatten_kmajor(bank.templates, 10),
                                layout.valid_kmajor(bank.valid, 10), 10)
    check(torch.equal(pred, want), "predict: kernel preds differ from the "
          "plain path on the same features")
    acc = float((pred.cpu().numpy() == test_y).mean())
    report["predict"] = dict(launches=counts, wall_s=wall, features=n,
                             accuracy_vs_labels=acc,
                             profile=profile(lambda: clf.predict(test_x)))

    # -- HybridService ticks: mega (B3) and compose (B4) ---------------------
    tenants = []
    for t in range(8):
        tp = rng.standard_normal((10, 32, 32, 1)).astype(np.float32)
        x = class_images(rng, tp, cal_y, 0.5)
        th = fit_acam_head(student_features, model, x, cal_y, 10,
                           device=device)
        cents = student_features(model, tp).cpu().numpy()  # (10, n)
        head_wb = (cents.T.copy(), (-0.5 * (cents**2).sum(1)).astype(
            np.float32))
        tenants.append((f"tenant{t}", th.bank, head_wb, tp))
    requests = []
    for i in range(256):
        tid, _, _, tp = tenants[i % 8]
        a, b = rng.integers(0, 10, 2)
        # one request in four blends two classes: a low-margin query
        img = tp[a] if i % 4 else 0.5 * (tp[a] + tp[b])
        img = img + 0.3 * rng.standard_normal(img.shape).astype(np.float32)
        requests.append((tid, img))
    req_feats = student_features(
        model, np.stack([img for _, img in requests])).cpu().numpy()

    def service(fusion: str, on=device):
        spec = ServiceSpec(
            registry=RegistrySpec(num_features=n),
            engine=EngineConfig(backend="kernel", margin=True,
                                serve_fusion=fusion),
            scheduler=SchedulerSpec(slots=64),
            cascade=CascadeSpec(tau=8.0, tau_units="count"))
        svc = HybridService.from_spec(spec, device=on)
        for tid, bnk, hwb, _ in tenants:
            svc.register_tenant(tid, bnk, head=hwb)
        return svc

    served = {}
    for fusion, kernel in (("mega", "acam_match_serve"),
                           ("compose", "acam_match_classify_margins")):
        svc = service(fusion)
        reqs = [ClassifyRequest(tid, f)
                for (tid, _), f in zip(requests, req_feats)]
        resp, counts, wall = drive(f"serve_{fusion}",
                                   lambda: svc.serve(reqs), [kernel])
        m = svc.metrics()
        check(all(r.error is None for r in resp) and len(resp) == 256,
              f"serve_{fusion}: every request answered without error")
        check(counts[kernel] == m["classify_dispatches"],
              f"serve_{fusion}: {counts[kernel]} launches vs "
              f"{m['classify_dispatches']} dispatches")
        check(0.0 < m["escalation_rate"] < 1.0,
              f"serve_{fusion}: escalation rate {m['escalation_rate']}")
        served[fusion] = resp
        # one tick's matching call alone, on device-resident operands
        entries = [svc.registry.get(tid) for tid, _ in requests[:64]]
        tick_in = [torch.as_tensor(v, device=device) for v in (
            req_feats[:64], [e.slot for e in entries],
            [e.window[0] for e in entries], [e.window[1] for e in entries],
            [8.0] * 64)]
        eng = match.engine_from_config(svc.spec.engine)
        call_ms = time_ms(lambda: eng.classify_serve(
            tick_in[0], svc.registry.thresholds_table(), tick_in[1],
            svc.registry.device_bank(), tick_in[2], tick_in[3], tick_in[4]))
        report[f"serve_{fusion}"] = dict(
            launches=counts, wall_s=wall, metrics=m,
            energy=svc.obs.ledger.fleet(),
            tick_ms=m["tick_time_s"] / m["ticks"] * 1e3,
            engine_call_ms=call_ms,
            # the same 256 requests again, traced (after the metrics read)
            profile=profile(lambda: svc.serve(reqs)))
    # the reference: the same service on the CPU, where every kernel runs
    # its plain version (held bit-identical to the JAX package by the tests)
    cpu = service("mega", torch.device("cpu")).serve(
        [ClassifyRequest(tid, f) for (tid, _), f in zip(requests, req_feats)])
    for name, other in (("compose", served["compose"]), ("cpu", cpu)):
        for a, b in zip(served["mega"], other):
            check((a.pred, a.margin, a.escalated, a.energy_j) ==
                  (b.pred, b.margin, b.escalated, b.energy_j),
                  f"the mega tick on the card and the {name} path disagree")

    # -- big bank past MAX_FUSED_ROWS (B2) ----------------------------------
    x = case(11, 64, 1100, 2, n, device)
    from repro_torch.core.templates import TemplateBank

    big = TemplateBank(x["t"], x["t"], x["t"], x["valid"], x["thr"])
    check(2 * layout.padded_classes(1100) > match.MAX_FUSED_ROWS,
          "big bank exceeds the fused-row budget")
    eng = match.engine_for(backend="kernel")
    (pred, per_class), counts, wall = drive(
        "big_bank", lambda: eng.classify_features(x["f"], big),
        ["acam_match_classify_margins_chunked"])
    want = am.classify_margins_chunked_plain(
        x["f"], x["thr"], layout.stack_kcp(x["t"], 1100),
        layout.valid_kcp(x["valid"], 1100),
        torch.zeros(64, dtype=torch.int32, device=device),
        torch.full((64,), 1100, dtype=torch.int32, device=device), 1100,
        chunk=layout.class_chunk(1152, 2, match.MAX_FUSED_ROWS))
    check(torch.equal(pred, want[0]) and torch.equal(per_class, want[1]),
          "big bank: kernel differs from the plain path")
    report["big_bank"] = dict(launches=counts, wall_s=wall)
    return report


def main(argv: list[str]) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--report", type=Path, default=None,
                        help="also write every measurement as JSON here")
    report_path = parser.parse_args(argv).report
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    if not (ROOT / SOURCE).is_file():
        print(f"chip_smoke: {SOURCE} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda", 0)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build(["acam_match"])
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s")
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}")

    kernels = kernel_phase(device)
    report = paths(device)
    check(report["predict"]["features"] == N, "paper width: 784 features")
    launches = {}
    for path in report.values():
        for k, v in path["launches"].items():
            launches[k] = max(launches.get(k, 0), v)
    for name in ("predict", "serve_mega", "serve_compose", "big_bank"):
        r = report[name]
        print(f"{name}: wall {r['wall_s'] * 1e3:.3f} ms, launches "
              f"{r['launches']}")
        if "metrics" in r:
            print(f"{name}: tick {r['tick_ms']:.4f} ms, engine call "
                  f"{r['engine_call_ms']:.4f} ms")
            print(f"{name} metrics: {json.dumps(r['metrics'])}")
            print(f"{name} energy: {json.dumps(r['energy'])}")
    for name, k in kernels.items():
        print(f"{name} profile (per call): {json.dumps(k['profile'])}")
    for name in ("predict", "serve_mega", "serve_compose"):
        print(f"{name} profile: {json.dumps(report[name]['profile'])}")
    print(f"predict accuracy vs labels: "
          f"{report['predict']['accuracy_vs_labels']}")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_SITE}:{PALLAS_LINE[name]}",
         "launches": launches[name], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"],
         "library_call": "torch.matmul bipolar score product only (partial)",
         "device_ms": k["profile"]["device_ms"], "shape": k["shape"]}
        for name, k in kernels.items()]}
    if report_path:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(
            dict(card=smi, build_s=build_s, kernels=line["kernels"],
                 paths=report), indent=1, default=str))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
