"""The port's fleet layer (`repro_torch.fleet`) against the JAX package's
(`repro.fleet`): manifests as values (JSON text, validation, diffs, tau
units), bank checkpoints in both directions, `materialize`,
`apply_manifest` on live services, the pure policy over a grid of views,
and the autopilot's action log over one trace. On one card the policy's
shard escalation (rule 1) is blocked with ``mesh.install`` set, and the
port's `Autopilot` raises `NotImplementedError` where the JAX one would
reshard.
"""
import itertools
import json

import numpy as np
import pytest

from _torch_parity import to_np
from repro import fleet as jfleet
from repro.serve import acam_service as jsvc_lib
from repro.serve import spec as jspec
from repro.serve.control import HybridService as JService
from repro_torch import convert
from repro_torch import fleet as tfleet
from repro_torch.serve import acam_service as tsvc_lib
from repro_torch.serve import spec as tspec
from repro_torch.serve.control import HybridService as TService

N = 64


def _spec(m, backend="kernel", *, slots=16, tau=6.0, install=False,
          initial_classes=128):
    return m.ServiceSpec(
        registry=m.RegistrySpec(num_features=N,
                                initial_classes=initial_classes),
        engine=m.EngineConfig(backend=backend, margin=True),
        mesh=m.MeshSpec(install=install),
        scheduler=m.SchedulerSpec(slots=slots),
        cascade=m.CascadeSpec(tau=tau, tau_units="count"))


def _manifest(f, tenants=3, **kw):
    return f.FleetManifest(tenants=tuple(
        f.TenantSpec(f"t{t}", seed=1000 + 17 * t, num_classes=8 + 4 * t,
                     **kw) for t in range(tenants)))


# ---------------------------------------------------------------------------
# manifests as values
# ---------------------------------------------------------------------------

def test_manifest_json_text_matches_jax():
    for kw in ({}, {"tau": 5.0, "tau_units": "fraction", "k": 2,
                    "head": False, "epoch": 3}):
        t, j = _manifest(tfleet, **kw), _manifest(jfleet, **kw)
        assert t.to_json() == j.to_json()
        assert tfleet.FleetManifest.from_json(j.to_json()) == t.normalized()
        rev = tfleet.FleetManifest(tenants=tuple(reversed(t.tenants)))
        assert rev.normalized() == t.normalized() and hash(
            rev.normalized()) == hash(t.validate().normalized())


@pytest.mark.parametrize("fields", [
    dict(tenant_id="t", seed=1, checkpoint="x.npz"), dict(tenant_id="t"),
    dict(tenant_id="", seed=1), dict(tenant_id="t", seed=1,
                                      tau_units="volts"),
    dict(tenant_id="t", seed=1, tau=-1.0),
    dict(tenant_id="t", seed=1, num_classes=0)])
def test_validation_matches_jax(fields):
    with pytest.raises(jfleet.ManifestError) as jerr:
        jfleet.TenantSpec(**fields).validate()
    with pytest.raises(tfleet.ManifestError) as terr:
        tfleet.TenantSpec(**fields).validate()
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(tfleet.ManifestError, match="duplicate"):
        tfleet.FleetManifest(tenants=(tfleet.TenantSpec("t", seed=1),
                                      tfleet.TenantSpec("t", seed=2))
                             ).validate()


def test_diff_and_tau_units_match_jax():
    def cases(f):
        old = _manifest(f, 4)
        by = old.by_id()
        yield old, old
        yield old, f.FleetManifest(tenants=(
            by["t0"], by["t1"]._replace(seed=999), by["t2"]._replace(
                tau=3.0), f.TenantSpec("t9", seed=5)))
        yield old, f.FleetManifest(tenants=(by["t0"]._replace(epoch=1),
                                            by["t3"]))
        yield old, f.FleetManifest(tenants=(by["t1"]._replace(
            tau=6.0 / N, tau_units="fraction"),))
        a = f.TenantSpec("c", checkpoint="a.npz")
        yield (f.FleetManifest(tenants=(a,)),
               f.FleetManifest(tenants=(a._replace(checkpoint="b.npz"),)))

    for (to, tn), (jo, jn) in zip(cases(tfleet), cases(jfleet)):
        assert tuple(tfleet.diff_manifests(to, tn)) == \
            tuple(jfleet.diff_manifests(jo, jn))
    for args in ((None, "count", "fraction"), (6.0, "count", "count"),
                 (6.0, "count", "fraction"), (0.1, "fraction", "count")):
        assert tfleet.tau_in_units(*args, N) == jfleet.tau_in_units(*args, N)


# ---------------------------------------------------------------------------
# bank checkpoints and materialize
# ---------------------------------------------------------------------------

def test_bank_checkpoints_both_ways(tmp_path):
    jbank, jhead, _ = jsvc_lib.make_synthetic_tenant(7, num_classes=12, k=2,
                                                     num_features=N)
    tbank = convert.bank_from_numpy(*(to_np(a) for a in jbank),
                                    device="cpu")
    jfleet.save_bank(str(tmp_path / "j.npz"), jbank, head=jhead)
    tfleet.save_bank(str(tmp_path / "t.npz"), tbank, head=jhead)
    tfleet.save_bank(str(tmp_path / "headless.npz"), tbank)
    for path in ("j.npz", "t.npz"):
        (tb, th), (jb, jh) = (tfleet.load_bank(str(tmp_path / path)),
                              jfleet.load_bank(str(tmp_path / path)))
        for field in jb._fields:
            np.testing.assert_array_equal(getattr(tb, field),
                                          to_np(getattr(jbank, field)))
            np.testing.assert_array_equal(getattr(tb, field),
                                          getattr(jb, field))
        np.testing.assert_array_equal(th[0], jh[0])
        np.testing.assert_array_equal(th[1], jh[1])
    assert tfleet.load_bank(str(tmp_path / "headless.npz"))[1] is None
    np.savez(tmp_path / "bad.npz", templates=np.zeros((1, 1, N)))
    with pytest.raises(tfleet.ManifestError, match="missing arrays"):
        tfleet.load_bank(str(tmp_path / "bad.npz"))
    # materialize: a checkpoint source gives the same bytes in both
    spec = tfleet.TenantSpec("c", checkpoint=str(tmp_path / "j.npz"))
    jtenant = jfleet.TenantSpec(**spec._asdict())
    (tb, th), (jb, jh) = (tfleet.materialize(spec, N),
                          jfleet.materialize(jtenant, N))
    for field in jb._fields:
        np.testing.assert_array_equal(getattr(tb, field),
                                      to_np(getattr(jb, field)))
    with pytest.raises(tfleet.ManifestError, match="features"):
        tfleet.materialize(spec, 2 * N)


def test_materialize_seed_matches_jax():
    """A seed source is `make_synthetic_tenant`'s bank in each package,
    which agree as `test_torch_service.test_synthetic_tenant_matches_jax`
    holds them (thresholds within rtol 1e-5, templates bit for bit but for
    bits at a threshold)."""
    spec = tfleet.TenantSpec("s", seed=42, num_classes=8, k=2)
    jtenant = jfleet.TenantSpec(**spec._asdict())
    (tb, th), (jb, jh) = (tfleet.materialize(spec, N),
                          jfleet.materialize(jtenant, N))
    ref, ref_head, _ = tsvc_lib.make_synthetic_tenant(42, num_classes=8, k=2,
                                                      num_features=N)
    for field in ref._fields:
        assert np.array_equal(to_np(getattr(tb, field)),
                              to_np(getattr(ref, field)))
    np.testing.assert_allclose(to_np(tb.thresholds), to_np(jb.thresholds),
                               rtol=1e-5, atol=1e-6)
    assert (to_np(tb.templates) == to_np(jb.templates)).mean() > 0.99
    np.testing.assert_array_equal(th[0], jh[0])
    assert tfleet.materialize(spec._replace(head=False), N)[1] is None


def test_apply_manifest_matches_jax(tmp_path):
    """A sequence of manifests over checkpoint-sourced tenants (the same
    bytes in both packages): the same transitions, registry state and
    answers."""
    paths = []
    for i in range(4):
        bank, head, _ = jsvc_lib.make_synthetic_tenant(
            300 + i, num_classes=6 + 5 * i, num_features=N)
        paths.append(str(tmp_path / f"b{i}.npz"))
        jfleet.save_bank(paths[-1], bank, head=head)

    def manifests(f):
        base = tuple(f.TenantSpec(f"t{i}", checkpoint=paths[i])
                     for i in range(3))
        yield f.FleetManifest(tenants=base)
        yield f.FleetManifest(tenants=base)  # no-op
        yield f.FleetManifest(tenants=(
            base[0]._replace(tau=3.0), base[1]._replace(checkpoint=paths[3]),
            f.TenantSpec("t9", checkpoint=paths[0], head=False)))
        yield f.FleetManifest(tenants=(base[0]._replace(tau=3.0, epoch=1),))

    jsvc = JService.from_spec(_spec(jspec))
    tsvc = TService.from_spec(_spec(tspec), device="cpu")
    protos = jsvc_lib.make_synthetic_tenant(300, num_classes=6,
                                            num_features=N)[2]
    feats, _ = jsvc_lib.sample_tenant_queries(5, protos, 24, noise=0.9)
    for jm, tm in zip(manifests(jfleet), manifests(tfleet)):
        jr, tr = jsvc.apply_manifest(jm), tsvc.apply_manifest(tm)
        for field in ("added", "evicted", "updated", "retuned"):
            assert getattr(tr, field) == getattr(jr, field), field
        (ta, tmeta), (ja, jmeta) = (tsvc.registry.snapshot_state(),
                                    jsvc.registry.snapshot_state())
        assert tmeta == jmeta
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
        got = tsvc.serve([tsvc_lib.ClassifyRequest("t0", f) for f in feats])
        want = jsvc.serve([jsvc_lib.ClassifyRequest("t0", f) for f in feats])
        assert [(r.pred, r.margin, r.escalated, r.energy_j) for r in got] \
            == [(r.pred, r.margin, r.escalated, r.energy_j) for r in want]
    assert tr.empty is False and len(tsvc.registry) == 1


# ---------------------------------------------------------------------------
# the policy: a pure twin
# ---------------------------------------------------------------------------

def _view(f, m, *, backend="kernel", install=False, **kw):
    fields = dict(tenants=3, shard_rows_used=(96,), rows_per_shard=256,
                  capacity_classes=256, fused_rows_per_shard=512,
                  vmem_budget_rows=2048, queue_depth=0, p99_ms=1.0,
                  rolling_fill=4.0, slots=16, devices=1, backend_j=1e-9,
                  frontend_j=1e-6)
    fields.update(kw)
    return f.RegistryView(spec=_spec(m, backend, install=install,
                                     initial_classes=256), **fields)


GRID = dict(shard_rows_used=((0,), (96,), (192,), (224,)),
            queue_depth=(0, 64), rolling_fill=(4.0, 16.0),
            fused_rows_per_shard=(512, 2048),
            energy=((1e-9, 1e-6), (9.5e-6, 5e-7)), devices=(1, 2, 8),
            install=(False, True), backend=("kernel", "device"))


def test_policy_matches_jax_on_a_grid():
    actions = set()
    for values in itertools.product(*GRID.values()):
        kw = dict(zip(GRID, values))
        kw["backend_j"], kw["frontend_j"] = kw.pop("energy")
        tv, jv = _view(tfleet, tspec, **kw), _view(jfleet, jspec, **kw)
        for pol in ({}, {"max_bank_shards": 1, "max_slots": 16}):
            ta, tr, tt = tfleet.explain(tv, tfleet.PolicySpec(**pol))
            ja, jr, jt = jfleet.explain(jv, jfleet.PolicySpec(**pol))
            assert (ta, tr, tt.to_json()) == (ja, jr, jt.to_json()), kw
            assert tfleet.decide(tv).to_json() == jfleet.decide(jv).to_json()
            actions.add(ta)
        assert tfleet.should_compact(tv) == jfleet.should_compact(jv)
        assert tfleet.RegistryView.from_dict(
            json.loads(json.dumps(tv.to_dict()))) == tv
        if kw["install"] and kw["devices"] == 1:
            # one card with the mesh installed: never a shard escalation
            assert tfleet.explain(tv)[0] != "escalate_shards"
    assert actions == {"hold", "escalate_shards", "swap_backend",
                       "widen_slots"}


def _full_service(install: bool):
    svc = TService.from_spec(_spec(tspec, install=install), device="cpu")
    for t in range(8):  # 8 x 16 rows: the 128-row bank is full
        bank, head, _ = tsvc_lib.make_synthetic_tenant(
            50 + t, num_classes=10, num_features=N)
        svc.register_tenant(f"t{t}", bank, head=head)
    return svc


def test_shard_escalation_blocked_on_one_card():
    svc = _full_service(install=True)
    view = tfleet.view_of(svc)
    assert max(view.shard_rows_used) / view.rows_per_shard == 1.0
    assert view.devices == 1 and view.spec == svc.spec
    assert tfleet.explain(view)[0] == "hold"
    pilot = tfleet.Autopilot(svc, policy=tfleet.PolicySpec(
        interval=1, hysteresis=1))
    for _ in range(4):
        assert pilot.observe_tick() is None


def test_autopilot_refuses_a_shard_escalation():
    svc = _full_service(install=False)
    assert tfleet.explain(tfleet.view_of(svc))[0] == "escalate_shards"
    pilot = tfleet.Autopilot(svc, policy=tfleet.PolicySpec(
        interval=1, hysteresis=2))
    assert pilot.observe_tick() is None  # hysteresis: streak 1
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        pilot.observe_tick()
    assert svc.registry.bank_shards == 1 and pilot.actions == []


def _drive(svc, pilot, reqs, burst):
    responses, i = [], 0
    while i < len(reqs) or svc.scheduler.qsize:
        for r in reqs[i:i + burst]:
            svc.submit(r)
        i += burst
        responses.extend(svc.step())
        pilot.observe_tick()
        responses.extend(pilot.take_drained())
    return responses


def test_autopilot_action_log_matches_jax():
    """One trace through both autopilots: a ledger dominated by E_backend
    (tau 0.5: nothing escalates) swaps to the device backend, a flooded
    queue widens the slots, and a mostly empty bank compacts; the action
    logs (tick, action, reason) agree, and so does every answer (the
    device backend's margins within 1e-6: the JAX serve tick is jitted,
    and XLA turns the sense chain's divisions into reciprocal products)."""
    tenants = []
    for t in range(2):
        bank, head, p = jsvc_lib.make_synthetic_tenant(
            80 + t, num_classes=10, num_features=N)
        tenants.append((tuple(to_np(a) for a in bank), head, p))
    stream = []
    for i in range(160):
        f, _ = jsvc_lib.sample_tenant_queries(i, tenants[i % 2][2], 1)
        stream.append((f"t{i % 2}", f[0]))
    logs, answers = [], []
    for f, lib, svc_cls, m, port in (
            (jfleet, jsvc_lib, JService, jspec, False),
            (tfleet, tsvc_lib, TService, tspec, True)):
        spec = _spec(m, slots=4, tau=0.5, initial_classes=256)
        svc = (svc_cls.from_spec(spec, device="cpu") if port
               else svc_cls.from_spec(spec))
        for t, (arrays, head, _) in enumerate(tenants):
            bank = (convert.bank_from_numpy(*arrays, device="cpu") if port
                    else jsvc_lib.TemplateBank(*arrays))
            svc.register_tenant(f"t{t}", bank, head=head)
        pilot = f.Autopilot(svc, policy=f.PolicySpec(interval=2,
                                                     hysteresis=1,
                                                     cooldown=4))
        responses = _drive(svc, pilot, [lib.ClassifyRequest(t, x)
                                        for t, x in stream], burst=20)
        logs.append([(a["tick"], a["action"], a["reason"])
                     for a in pilot.actions])
        answers.append(sorted((r.request_id, r.pred, r.margin, r.escalated)
                              for r in responses))
    assert logs[1] == logs[0]
    assert {"swap_backend", "widen_slots", "compact"} <= {
        a for _, a, _ in logs[1]}
    assert [(i, p, e) for i, p, _, e in answers[1]] == \
        [(i, p, e) for i, p, _, e in answers[0]]
    np.testing.assert_allclose([a[2] for a in answers[1]],
                               [a[2] for a in answers[0]], rtol=0, atol=1e-6)
    assert [a[0] for a in answers[1]] == list(range(1, len(stream) + 1))
