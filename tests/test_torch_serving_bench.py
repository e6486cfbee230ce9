"""The port's serving bench and trace harness against the JAX package's
(`benchmarks/serving_bench.py`, `benchmarks/traces.py`), on the CPU.

The traces are the same op lists; the bench's sweep rows at smoke size
have the same escalation rate, nJ/request, occupancy and dispatch count as
the JAX bench's for the same seed. The device-backend row is held request
by request too: identical preds, margins bitwise equal and the same
escalations (the served device path computes the JAX serve tick's
compiled arithmetic, `core.acam.sense_compiled`). The burst, chaos, telemetry and mega-kernel rows run
their own checks (event log against the metrics, restored against clean
answers, both arms identical).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks import serving_bench as jbench  # noqa: E402
from benchmarks import traces as jtraces  # noqa: E402
from repro.serve import acam_service as jsvc_lib  # noqa: E402
from repro.serve.control import HybridService as JService  # noqa: E402
from repro_torch.benchmarks import serving_bench as tbench  # noqa: E402
from repro_torch.benchmarks import traces as ttraces  # noqa: E402
from repro_torch.serve.control import HybridService as TService  # noqa: E402

ROW_KEYS = ("escalation_rate", "nj_per_request", "occupancy",
            "classify_dispatches", "tenants", "slots", "requests",
            "classes", "matching_backend", "bank_sharding")


@pytest.mark.parametrize("cfg", [
    dict(), dict(seed=3, tenants=5, requests=200, churn_every=2),
    dict(seed=1, burst=64, calm=8, phase_ticks=1, requests=192)])
def test_traces_match_jax(cfg):
    tc, jc = ttraces.TraceConfig(**cfg), jtraces.TraceConfig(**cfg)
    assert ttraces.make_trace(tc) == jtraces.make_trace(jc)
    np.testing.assert_array_equal(ttraces.zipf_weights(tc),
                                  jtraces.zipf_weights(jc))
    tpool, jpool = ttraces.TenantPool(tc), jtraces.TenantPool(jc)
    for t in range(tc.tenants):
        a, b = tpool.request(t, 17 + t), jpool.request(t, 17 + t)
        assert a.tenant_id == b.tenant_id
        np.testing.assert_array_equal(a.features, b.features)


@pytest.mark.parametrize("tenants,slots", [(1, 1), (1, 64), (8, 1),
                                           (8, 64)])
def test_sweep_rows_match_jax(tenants, slots):
    requests = 2 * max(slots, 32)  # the smoke sweep's size
    got = tbench.bench_service(tenants, slots, requests=requests,
                               device="cpu")
    want = jbench.bench_service(tenants, slots, requests=requests)
    for key in ROW_KEYS:
        assert got[key] == want[key], key
    assert got["requests_per_s"] > 0 and got["latency_p99_ms"] > 0


def test_device_row_matches_jax_request_by_request():
    requests = 128
    tsvc = TService.from_spec(tbench.make_spec(64, requests=requests,
                                               backend="device"),
                              device="cpu")
    treqs = tbench._tenants_and_stream(tsvc, 8, requests, 0)
    jsvc = JService.from_spec(jbench.make_spec(64, requests=requests,
                                               backend="device"))
    for t in range(8):
        bank, head, _ = jsvc_lib.make_synthetic_tenant(
            t, num_classes=tbench.NUM_CLASSES,
            num_features=tbench.NUM_FEATURES)
        jsvc.register_tenant(f"t{t}", bank, head=head)
    jreqs = [jsvc_lib.ClassifyRequest(r.tenant_id, r.features)
             for r in treqs]
    got, want = tsvc.serve(treqs), jsvc.serve(jreqs)
    assert [r.pred for r in got] == [r.pred for r in want]
    np.testing.assert_array_equal(
        np.array([r.margin for r in got], np.float32),
        np.array([r.margin for r in want], np.float32))
    assert [r.escalated for r in got] == [r.escalated for r in want]
    row = tbench.bench_service(8, 64, requests=requests, backend="device",
                               device="cpu")
    jrow = jbench.bench_service(8, 64, requests=requests, backend="device")
    for key in ("occupancy", "classify_dispatches", "matching_backend",
                "escalation_rate", "nj_per_request"):
        assert row[key] == jrow[key], key


def test_burst_and_chaos_rows_match_jax():
    got, want = (tbench.burst_bench(smoke=True, device="cpu"),
                 jbench.burst_bench(smoke=True))
    for key in ROW_KEYS + ("shed_rate", "load_shed_ticks",
                           "shed_intervals", "trace"):
        assert got[key] == want[key], key
    got, want = (tbench.chaos_bench(smoke=True, device="cpu"),
                 jbench.chaos_bench(smoke=True))
    for key in ROW_KEYS + ("lost_in_flight", "trace"):
        assert got[key] == want[key], key
    assert got["recovery_ms"] > 0


def test_device_loss_needs_the_multi_gpu_slice():
    """Once refused, a chaos plan's device loss now fails over: under a
    forced 1x2 mesh the 2-shard service loses device 1 at tick 2 and
    finishes the trace on one shard (the queue drained by the transitions
    is not counted, as in the JAX harness); the heal reinstalls the mesh
    over both devices, and a probe serves what the loss-free service
    serves."""
    from _torch_parity import port_mesh
    from repro_torch.serve import spec as spec_lib

    cfg = ttraces.TraceConfig(seed=5, tenants=4, classes=10,
                              num_features=tbench.NUM_FEATURES, requests=96,
                              burst=24, calm=4, phase_ticks=1)
    spec = tbench.make_spec(8, requests=cfg.requests)
    spec = spec._replace(
        registry=spec.registry._replace(
            initial_classes=spec_lib.aligned_classes(2)),
        mesh=spec.mesh._replace(bank_shards=2, install=True))
    runs = {}
    for name, chaos in (("clean", None),
                        ("loss", ttraces.ChaosPlan(lose_devices_at=2,
                                                   heal_at_tick=5))):
        with port_mesh((1, 2)):
            svc = TService.from_spec(spec, device="cpu")
            pool = ttraces.TenantPool(cfg)
            pool.register_all(svc)
            svc, stats = ttraces.replay(svc, ttraces.make_trace(cfg), pool,
                                        chaos=chaos)
            probe = [pool.request(t % cfg.tenants, 555_000 + t)
                     for t in range(32)]
            runs[name] = (svc, stats, tbench._signature(svc.serve(probe)))
    (_, clean, want), (svc, loss, got) = runs["clean"], runs["loss"]
    assert loss["device_loss_downtime_ms"] is not None
    assert loss["post_loss_bank_shards"] == 1
    assert svc.registry.bank_shards == 1 and svc._devices is None
    assert svc.scheduler.qsize == 0 and loss["completed"] > 0
    assert loss["submitted"] == clean["submitted"]
    assert got == want


def test_run_writes_every_row(tmp_path, monkeypatch):
    monkeypatch.setattr(tbench, "PASSES", 1)
    out = tmp_path / "BENCH_torch_serving.json"
    rows = tbench.main(["--smoke", "--out", str(out)], device="cpu")
    payload = json.loads(out.read_text())
    assert payload["backend"] == "cpu" and payload["kernels"] == "plain"
    assert payload["card"] is None
    names = [r["name"] for r in rows]
    assert names == [
        "serving_t1_c10_s1", "serving_t1_c10_s64", "serving_t8_c10_s1",
        "serving_t8_c10_s64", "serving_t8_c10_s64_device",
        # the bank-scaling rows (replicated only: no forced mesh here)
        "serving_t4_c16_s64", "serving_t8_c32_s64",
        "serving_burst_t8_s32", "serving_chaos_recovery",
        "serving_telemetry_overhead", "serving_megakernel",
        "serving_lm_decode_only", "serving_lm_cache_h0",
        "serving_lm_cache_h50", "serving_lm_cache_h90"]
    assert [e for e in payload["entries"]] == [r["entry"] for r in rows]
    for e in payload["entries"]:
        assert e["requests_per_s"] > 0 and e["bank_sharding"] == 1
