"""The port's multi-tenant `HybridService` against the JAX package's.

Both services are built from the same `ServiceSpec` (whose JSON is the same
text in both packages), get the same tenants (the JAX banks and heads carried
across) and the same numpy request trace. Every response's pred, margin,
escalated, shed and energy_j, and the metrics' completed / escalated /
classify_dispatches counts, must be identical.
"""
import dataclasses
import time

import numpy as np
import pytest

from _torch_parity import to_np
from repro.serve import acam_service as jsvc_lib
from repro.serve import spec as jspec
from repro.serve.control import HybridService as JService
from repro_torch import convert
from repro_torch.serve import acam_service as tsvc_lib
from repro_torch.serve import spec as tspec
from repro_torch.serve.control import HybridService as TService

N = 64
TENANTS = 3


def _specs(backend="kernel", fusion="mega", **cascade):
    """The same spec in both packages (no mesh install: one device)."""
    def build(m):
        return m.ServiceSpec(
            registry=m.RegistrySpec(num_features=N),
            engine=m.EngineConfig(backend=backend, margin=True,
                                  serve_fusion=fusion),
            mesh=m.MeshSpec(install=False),
            scheduler=m.SchedulerSpec(slots=16),
            cascade=m.CascadeSpec(tau=6.0, tau_units="count", **cascade))
    return build(jspec), build(tspec)


def _services(js, ts):
    jsvc = JService.from_spec(js)
    tsvc = TService.from_spec(ts, device="cpu")
    protos = []
    for i in range(TENANTS):
        bank, head, p = jsvc_lib.make_synthetic_tenant(
            10 + i, num_classes=6 + 2 * i, num_features=N)
        jsvc.register_tenant(f"t{i}", bank, head=head)
        tsvc.register_tenant(
            f"t{i}", convert.bank_from_numpy(*(to_np(a) for a in bank),
                                             device="cpu"),
            head=(np.array(head[0]), np.array(head[1])))
        protos.append(p)
    return jsvc, tsvc, protos


def _trace(protos, n, seed=0):
    out = []
    for i in range(n):
        tid = i % TENANTS
        f, _ = jsvc_lib.sample_tenant_queries(seed + i, protos[tid], 1,
                                              noise=0.9)
        out.append((f"t{tid}", f[0]))
    return out


def _serve_both(jsvc, tsvc, trace):
    jr = jsvc.serve([jsvc_lib.ClassifyRequest(tid, f) for tid, f in trace])
    tr = tsvc.serve([tsvc_lib.ClassifyRequest(tid, f) for tid, f in trace])
    return jr, tr


def _same_responses(jr, tr):
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert (a.request_id, a.tenant_id, a.pred, a.margin, a.escalated,
                a.shed, a.energy_j, a.error, a.score) == \
            (b.request_id, b.tenant_id, b.pred, b.margin, b.escalated,
             b.shed, b.energy_j, b.error, b.score)


def _same_counts(jsvc, tsvc):
    jm, tm = jsvc.metrics(), tsvc.metrics()
    for key in ("completed", "escalated", "classify_dispatches", "failed",
                "shed", "ticks", "served", "energy_total_j", "expired"):
        assert jm[key] == tm[key], key
    return tm


def test_spec_json_is_the_same_text():
    js, ts = _specs()
    assert ts.to_json() == js.to_json()
    assert tspec.ServiceSpec.from_json(js.to_json()) == ts
    dflt_j, dflt_t = jspec.ServiceSpec(), tspec.ServiceSpec()
    assert dflt_t.to_json() == dflt_j.to_json()
    assert dflt_t.to_json(indent=None) == dflt_j.to_json(indent=None)


def test_spec_refuses_what_the_port_lacks():
    js, ts = _specs()
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ts._replace(mesh=ts.mesh._replace(bank_shards=2)).validate()
    # a "device" spec validates in both packages, and both serve its
    # margins in matchline fractions with tau rescaled by 1/N
    jd = js._replace(engine=js.engine._replace(backend="device")).validate()
    td = ts._replace(engine=ts.engine._replace(backend="device")).validate()
    assert td.to_json() == jd.to_json()
    assert td.native_tau_units == jd.native_tau_units == "fraction"
    assert td.tau_scale() == jd.tau_scale() == 1.0 / N


@pytest.mark.parametrize("backend,fusion", [("kernel", "mega"),
                                            ("kernel", "compose"),
                                            ("reference", "mega")])
def test_response_stream_identical(backend, fusion):
    jsvc, tsvc, protos = _services(*_specs(backend, fusion))
    jr, tr = _serve_both(jsvc, tsvc, _trace(protos, 40))
    _same_responses(jr, tr)
    m = _same_counts(jsvc, tsvc)
    assert m["completed"] == 40 and m["classify_dispatches"] == 3
    assert 0 < m["escalated"] < 40
    assert tsvc.obs.ledger.fleet_j() == sum(r.energy_j for r in tr)


def test_deadline_expiry_identical():
    jsvc, tsvc, protos = _services(*_specs(deadline_ms=1.0))
    trace = _trace(protos, 20, seed=5)
    for tid, f in trace:
        jsvc.submit(jsvc_lib.ClassifyRequest(tid, f))
        tsvc.submit(tsvc_lib.ClassifyRequest(tid, f))
    time.sleep(0.01)
    jr, tr = jsvc.step(), tsvc.step()
    assert len(tr) == 20 and all("deadline" in r.error for r in tr)
    _same_responses(jr, tr)
    m = _same_counts(jsvc, tsvc)
    assert m["expired"] == 20 and m["classify_dispatches"] == 0


def test_shed_tick_identical():
    """Queue depth at the shed threshold: the first tick answers from the
    ACAM stage alone (shed=True where the margin asked for escalation)."""
    jsvc, tsvc, protos = _services(*_specs(shed_queue=20))
    jr, tr = _serve_both(jsvc, tsvc, _trace(protos, 40, seed=9))
    _same_responses(jr, tr)
    m = _same_counts(jsvc, tsvc)
    assert m["shed"] > 0 and tsvc.metrics()["load_shed_ticks"] == \
        jsvc.metrics()["load_shed_ticks"] > 0


def test_tenant_lifecycle_and_evicted_while_queued():
    jsvc, tsvc, protos = _services(*_specs())
    trace = _trace(protos, 12, seed=3)
    for tid, f in trace:
        jsvc.submit(jsvc_lib.ClassifyRequest(tid, f))
        tsvc.submit(tsvc_lib.ClassifyRequest(tid, f))
    jsvc.evict_tenant("t1")
    tsvc.evict_tenant("t1")
    _same_responses(jsvc.drain(), tsvc.drain())
    assert tsvc.registry.lookup("t1") is None
    # re-register into the freed range, retune
    bank, head, _ = jsvc_lib.make_synthetic_tenant(99, num_classes=20,
                                                   num_features=N)
    small, small_head, _ = jsvc_lib.make_synthetic_tenant(
        98, num_classes=5, num_features=N)
    for svc, b, s in ((jsvc, bank, small), (tsvc, *(
            convert.bank_from_numpy(*(to_np(a) for a in x), device="cpu")
            for x in (bank, small)))):
        svc.register_tenant("t9", b, head=head)
        svc.retune_tenant("t0", margin_tau=2.0)
        svc.update_tenant("t2", s, head=small_head)  # in place: fits
    assert tsvc.registry.get("t9").offset == jsvc.registry.get("t9").offset
    feats, _ = jsvc_lib.sample_tenant_queries(4, protos[0], 10, noise=0.9)
    jr, tr = _serve_both(jsvc, tsvc, [("t0", f) for f in feats])
    _same_responses(jr, tr)
    np.testing.assert_array_equal(tsvc.head_of("t9")[0], jsvc.head_of("t9")[0])
    assert tsvc.registry.get("t2").num_classes == 5
    assert tsvc.registry.get("t2").offset == jsvc.registry.get("t2").offset
    assert tsvc.health()["tenants"] == 3
    tsvc.reset_metrics()
    assert tsvc.metrics()["completed"] == 0
    assert tsvc.scheduler.stats.ticks == 0


def test_synthetic_tenant_matches_jax():
    jb, jh, jp = jsvc_lib.make_synthetic_tenant(7, num_classes=5,
                                                num_features=N)
    tb, th, tp = tsvc_lib.make_synthetic_tenant(7, num_classes=5,
                                                num_features=N)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(th[0], jh[0])
    np.testing.assert_array_equal(th[1], jh[1])
    np.testing.assert_allclose(tb.thresholds.numpy(), to_np(jb.thresholds),
                               rtol=1e-5, atol=1e-6)
    assert (tb.templates.numpy() == to_np(jb.templates)).mean() > 0.99
    f, y = tsvc_lib.sample_tenant_queries(3, tp, 9)
    jf, jy = jsvc_lib.sample_tenant_queries(3, jp, 9)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(y, jy)


def test_capacity_growth_and_device_caches():
    """Registering past the initial class and tenant capacity doubles both
    in the same places in both packages; device views are cached per
    registry generation and rebuilt after a mutation."""
    js, ts = _specs()
    js = js._replace(registry=js.registry._replace(initial_classes=32,
                                                   initial_tenants=2))
    ts = ts._replace(registry=ts.registry._replace(initial_classes=32,
                                                   initial_tenants=2))
    jsvc, tsvc = JService.from_spec(js), TService.from_spec(ts, device="cpu")
    protos = []
    for i in range(5):
        bank, head, p = jsvc_lib.make_synthetic_tenant(
            40 + i, num_classes=(12, 20, 3, 17, 9)[i], num_features=N)
        jsvc.register_tenant(f"t{i}", bank, head=head)
        tsvc.register_tenant(
            f"t{i}", convert.bank_from_numpy(*(to_np(a) for a in bank),
                                             device="cpu"), head=head)
        protos.append(p)
    for i in range(5):
        assert dataclasses.astuple(tsvc.registry.get(f"t{i}")) == \
            dataclasses.astuple(jsvc.registry.get(f"t{i}"))
    assert tsvc.registry.stats() == {
        k: v for k, v in jsvc.registry.stats().items()
        if k in tsvc.registry.stats()}
    assert tsvc.registry.capacity_tenants == 8
    bank = tsvc.registry.device_bank()
    assert tsvc.registry.device_bank() is bank
    assert tsvc.registry.thresholds_table() is \
        tsvc.registry.thresholds_table()
    jr, tr = _serve_both(jsvc, tsvc, [
        (f"t{i % 5}", jsvc_lib.sample_tenant_queries(i, protos[i % 5], 1)[0][0])
        for i in range(20)])
    _same_responses(jr, tr)
    tsvc.evict_tenant("t0")
    assert tsvc.registry.device_bank() is not bank
