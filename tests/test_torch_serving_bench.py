"""The port's serving bench and trace harness against the JAX package's
(`benchmarks/serving_bench.py`, `benchmarks/traces.py`), on the CPU.

The traces are the same op lists; the bench's sweep rows at smoke size
have the same escalation rate, nJ/request, occupancy and dispatch count as
the JAX bench's for the same seed. The device-backend row is held request
by request instead: identical preds, margins within 1e-6, and the same
escalations except where the JAX margin sits within 1e-6 of tau (the JAX
serve tick is jitted, and XLA turns the sense chain's divisions into
reciprocal products: a margin of exactly tau there can be one ulp under
it in the port). The burst, chaos, telemetry and mega-kernel rows run
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
    requests, tau = 128, 8.0 / tbench.NUM_FEATURES
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
    np.testing.assert_allclose([r.margin for r in got],
                               [r.margin for r in want], rtol=0, atol=1e-6)
    for g, w in zip(got, want):
        if abs(w.margin - tau) > 1e-6:
            assert g.escalated == w.escalated
    row = tbench.bench_service(8, 64, requests=requests, backend="device",
                               device="cpu")
    jrow = jbench.bench_service(8, 64, requests=requests, backend="device")
    for key in ("occupancy", "classify_dispatches", "matching_backend"):
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
    cfg = ttraces.TraceConfig(requests=8)
    pool = ttraces.TenantPool(cfg)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ttraces.replay(None, ttraces.make_trace(cfg), pool,
                       chaos=ttraces.ChaosPlan(lose_devices_at=2))


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
        "serving_burst_t8_s32", "serving_chaos_recovery",
        "serving_telemetry_overhead", "serving_megakernel"]
    assert [e for e in payload["entries"]] == [r["entry"] for r in rows]
    for e in payload["entries"]:
        assert e["requests_per_s"] > 0 and e["bank_sharding"] == 1
