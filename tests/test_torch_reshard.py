"""The port's sharded service and its mesh transitions against the JAX
package's: the registry's reshard, the sharded service, the drained and
the rolling reshard, device loss and heal, snapshots across shard counts
and packages, the autopilot's shard escalation, the chaos replay's device
loss, and the serving bench's sharded rows.

The port runs under forced meshes of the CPU (`repro_torch.distributed.
forcemesh`). Oracles: the JAX registry in process (pure numpy), a fresh
build of the target spec, and JAX's sharded service on forced host
devices in two subprocesses started with the module (their answers: one
JSON object each). Feature-count answers (pred, escalated, margin) are
equal bit for bit; tenant banks are the JAX synthetic tenants carried
across.
"""
import numpy as np
import pytest
import torch

from _torch_parity import JaxJob, port_mesh, to_np
from repro.core.templates import TemplateBank as JBank
from repro.serve import acam_service as jsvc_lib
from repro.serve.registry import RegistryError as JRegistryError
from repro.serve.registry import TemplateBankRegistry as JRegistry
from repro_torch import convert
from repro_torch import match as tmatch
from repro_torch.benchmarks import serving_bench as tbench
from repro_torch.benchmarks import traces as ttraces
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.templates import TemplateBank as TBank
from repro_torch.distributed import context
from repro_torch.fleet import reshard as reshard_lib
from repro_torch.match.config import EngineConfig
from repro_torch.serve import acam_service as tsvc_lib
from repro_torch.serve import spec as tspec
from repro_torch.serve.control import HybridService as TService
from repro_torch.serve.registry import RegistryError
from repro_torch.serve.registry import TemplateBankRegistry as TRegistry

N = 64
LAYOUTS = {"edge_packed": [24] * 7, "straddle_skip": [40] * 4}
#: timing fields of the bench rows (host clocks): every other field must
#: equal the JAX row's
TIMINGS = ("requests_per_s", "latency_p50_ms", "latency_p99_ms",
           "reshard_downtime_ms", "flip_downtime_ms", "drained_downtime_ms",
           "recovery_ms")


@pytest.fixture(autouse=True)
def no_mesh(monkeypatch):
    monkeypatch.delenv("REPRO_FORCE_MESH", raising=False)
    monkeypatch.delenv("REPRO_REDUCE_STRATEGY", raising=False)
    context.clear()
    yield
    context.clear()


def _tenant(seed, classes):
    """A JAX synthetic tenant carried into the port: (bank, head, protos)."""
    bank, head, p = jsvc_lib.make_synthetic_tenant(seed, num_classes=classes,
                                                   num_features=N)
    return (convert.bank_from_numpy(*(to_np(a) for a in bank),
                                    device="cpu"),
            (np.array(head[0]), np.array(head[1])), p)


def _sig(responses):
    return [[r.tenant_id, int(r.pred), bool(r.escalated), float(r.margin)]
            for r in responses]


def _snap_spec(shards):
    """The JAX resilience tests' spec: 4 tenants x 40 classes, 256 rows."""
    return tspec.ServiceSpec(
        registry=tspec.RegistrySpec(num_features=N, initial_classes=256),
        engine=EngineConfig(backend="reference", margin=True),
        mesh=tspec.MeshSpec(bank_shards=shards, install=True),
        scheduler=tspec.SchedulerSpec(slots=16),
        cascade=tspec.CascadeSpec(tau=6.0, tau_units="count"))


def _snap_populate(svc):
    for t in range(4):
        bank, head, _ = _tenant(1000 + 17 * t, 40)
        svc.register_tenant(f"t{t}", bank, head=head)


def _snap_requests():
    reqs = []
    for t in range(4):
        _, _, p = jsvc_lib.make_synthetic_tenant(1000 + 17 * t,
                                                 num_classes=40,
                                                 num_features=N)
        f, _ = jsvc_lib.sample_tenant_queries(7 + t, p, 30, noise=0.9)
        reqs += [(f"t{t}", np.asarray(f[j])) for j in range(30)]
    return reqs


def _serve_snap(svc):
    return _sig(svc.serve([tsvc_lib.ClassifyRequest(t, f)
                           for t, f in _snap_requests()]))


# ---------------------------------------------------------------------------
# JAX's sharded runs (started with the module, collected by the tests)
# ---------------------------------------------------------------------------

_JAX_SERVICE = """
    import json
    import jax
    import numpy as np
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.distributed import context
    from repro.fleet import FleetManifest, TenantSpec
    from repro.fleet import reshard as reshard_lib
    from repro.match.config import EngineConfig
    from repro.serve import acam_service as svc_lib
    from repro.serve.control import HybridService
    from repro.serve.spec import (CascadeSpec, MeshSpec, RegistrySpec,
                                  SchedulerSpec, ServiceSpec)

    N = 64
    LAYOUTS = {layouts!r}
    out = {{}}

    def sig(rs):
        return [[r.tenant_id, int(r.pred), bool(r.escalated),
                 float(r.margin)] for r in rs]

    # the sharded half of test_bank_sharding's service scenario (2x2)
    for layout in LAYOUTS:
        for slots, churn in ((64, False), (16, True)):
            context.clear()
            context.set_mesh_axes("data", "model",
                                  jax.make_mesh((2, 2), ("data", "model")))
            svc = svc_lib.ACAMService(
                N, config=svc_lib.ServiceConfig(slots=slots,
                                                margin_tau=6.0))
            protos = {{}}
            for t, classes in enumerate(LAYOUTS[layout]):
                bank, head, p = svc_lib.make_synthetic_tenant(
                    1000 + 17 * t, num_classes=classes, num_features=N)
                svc.register_tenant(f"t{{t}}", bank, head=head)
                protos[f"t{{t}}"] = p
            if churn:
                svc.evict_tenant("t1")
                bank, head, p = svc_lib.make_synthetic_tenant(
                    2000, num_classes=40, num_features=N)
                svc.register_tenant("tx", bank, head=head)
                protos["tx"] = p
                del protos["t1"]
            reqs = []
            for i, (tid, p) in enumerate(sorted(protos.items())):
                f, _ = svc_lib.sample_tenant_queries(7 + i, p, 40, noise=0.9)
                reqs += [svc_lib.ClassifyRequest(tid, f[j])
                         for j in range(40)]
            out[f"svc_{{layout}}_{{slots}}_{{churn}}"] = sig(svc.serve(reqs))
            out[f"offsets_{{layout}}_{{slots}}_{{churn}}"] = {{
                t: svc.registry.get(t).offset for t in protos}}
    context.clear()

    # test_fleet's rolling flip on 2x2
    spec = ServiceSpec(
        registry=RegistrySpec(num_features=N, initial_classes=256),
        engine=EngineConfig(backend="kernel", margin=True),
        mesh=MeshSpec(bank_shards=1),
        scheduler=SchedulerSpec(slots=16),
        cascade=CascadeSpec(tau=6.0, tau_units="count"))
    svc = HybridService.from_spec(spec)
    svc.apply_manifest(FleetManifest(tenants=tuple(
        TenantSpec(f"t{{t}}", seed=1000 + 17 * t, num_classes=40)
        for t in range(4))))
    protos = {{f"t{{t}}": svc_lib.make_synthetic_tenant(
        1000 + 17 * t, num_classes=40, num_features=N)[2] for t in range(4)}}
    reqs = []
    for i, (tid, p) in enumerate(sorted(protos.items())):
        f, _ = svc_lib.sample_tenant_queries(7 + i, p, 24, noise=0.9)
        reqs += [svc_lib.ClassifyRequest(tid, f[j]) for j in range(24)]
    out["flip_base"] = sig(svc.serve(reqs))
    for r in reqs[:16]:
        svc.submit(r)
    prep = reshard_lib.prepare(svc, spec._replace(
        mesh=MeshSpec(bank_shards=2)))
    report = svc.rolling_reshard(prep.spec, prepared=prep)
    flipped = []
    while svc.scheduler.qsize:
        flipped.extend(svc.step())
    out["flip_queued"] = sig(flipped)
    out["flip_full"] = sig(svc.serve(reqs))
    out["flip_moved"] = report.tenants_moved
    context.clear()

    # snapshots: JAX's at 2 shards, and the port's restored at 4
    spec = ServiceSpec(
        registry=RegistrySpec(num_features=N, initial_classes=256),
        engine=EngineConfig(backend="reference", margin=True),
        mesh=MeshSpec(bank_shards=2, install=True),
        scheduler=SchedulerSpec(slots=16),
        cascade=CascadeSpec(tau=6.0, tau_units="count"))
    svc = HybridService.from_spec(spec)
    reqs = []
    for t in range(4):
        bank, head, p = svc_lib.make_synthetic_tenant(
            1000 + 17 * t, num_classes=40, num_features=N)
        svc.register_tenant(f"t{{t}}", bank, head=head)
        f, _ = svc_lib.sample_tenant_queries(7 + t, p, 30, noise=0.9)
        reqs += [svc_lib.ClassifyRequest(f"t{{t}}", f[j]) for j in range(30)]
    out["snap_sig"] = sig(svc.serve(reqs))
    svc.snapshot(Checkpointer({jax_dir!r}))
    context.clear()
    svc, report = HybridService.restore(
        Checkpointer({port_dir!r}), mesh=MeshSpec(bank_shards=4,
                                                  install=True))
    out["port_snap_at4"] = sig(svc.serve(reqs))
    out["port_snap_report"] = [report.resharded, report.tenants,
                               svc.registry.bank_shards]
    print("OUT", json.dumps(out))
"""

_JAX_BENCH = """
    import json, sys
    sys.path.insert(0, {root!r})
    from benchmarks import serving_bench as b
    out = {{"scaling": b.bank_scaling_sweep(smoke=True),
            "reshard": b.reshard_bench(),
            "autopilot": b.autopilot_bench(smoke=True),
            "chaos": b.chaos_bench(smoke=True)}}
    print("OUT", json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _jax_jobs(tmp_path_factory):
    """Write the port's 2-shard snapshot (JAX restores it), then start both
    JAX jobs; the port-only tests run while they do."""
    import os

    from _torch_parity import SRC

    root = tmp_path_factory.mktemp("reshard")
    port_dir, jax_dir = str(root / "port_ckpt"), str(root / "jax_ckpt")
    with port_mesh((1, 4)):
        svc = TService.from_spec(_snap_spec(2), device="cpu")
        _snap_populate(svc)
        sig = _serve_snap(svc)
        svc.snapshot(Checkpointer(port_dir))
    service = JaxJob(_JAX_SERVICE.format(layouts=LAYOUTS, jax_dir=jax_dir,
                                         port_dir=port_dir), ndev=4)
    bench = JaxJob(_JAX_BENCH.format(
        root=os.path.abspath(os.path.join(SRC, ".."))), ndev=2,
        env={"REPRO_FORCE_MESH": "1x2"})
    return {"service": service, "bench": bench, "port_sig": sig,
            "port_dir": port_dir, "jax_dir": jax_dir}


# ---------------------------------------------------------------------------
# the registry (the JAX registry in process)
# ---------------------------------------------------------------------------

def _same_state(treg, jreg):
    (ta, tm), (ja, jm) = treg.snapshot_state(), jreg.snapshot_state()
    assert tm == jm
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def _churn(reg, bank_cls):
    rng = np.random.default_rng(4)

    def bank(c, k):
        tm = (rng.random((c, k, N)) > 0.5).astype(np.float32)
        return bank_cls(tm, tm * 0, tm * 0 + 1, rng.random((c, k)) < 0.9,
                        np.zeros(N, np.float32))

    for i, c in enumerate((10, 40, 12, 70, 24, 33, 5)):
        reg.register(f"t{i}", bank(c, 1 + i % 2))
    reg.evict("t2")
    reg.update("t0", bank(30, 1))  # relocates
    return reg


def test_prepare_reshard_and_reshard_match_jax_registry():
    jreg = _churn(JRegistry(N, bank_shards=2), JBank)
    treg = _churn(TRegistry(N, bank_shards=2, device="cpu"), TBank)
    _same_state(treg, jreg)
    for shards in (4, 3, 1, 8, 2):  # 3: 48-row alignment
        tp, jp = treg.prepare_reshard(shards), jreg.prepare_reshard(shards)
        assert (tp.capacity, tp.placements, tp.moved) == \
            (jp.capacity, jp.placements, jp.moved)
        assert treg.adopt_prepared(tp) == jreg.adopt_prepared(jp)
        _same_state(treg, jreg)
        assert treg.capacity_classes % (shards * 16) == 0
        rps = treg.rows_per_shard
        for t in list(treg._tenants):
            e = treg.get(t)
            assert e.offset // rps == (e.offset + e.c_bucket - 1) // rps
        assert treg.reshard(shards) == jreg.reshard(shards) == 0
    assert treg.reshard(4) == jreg.reshard(4)
    assert treg.compact() == jreg.compact()
    _same_state(treg, jreg)
    # a buffer built before a mutation is stale: both refuse it
    tp, jp = treg.prepare_reshard(2), jreg.prepare_reshard(2)
    treg.evict("t1")
    jreg.evict("t1")
    with pytest.raises(RegistryError, match="stale"):
        treg.adopt_prepared(tp)
    with pytest.raises(JRegistryError, match="stale"):
        jreg.adopt_prepared(jp)


# ---------------------------------------------------------------------------
# control-plane transitions, each against a fresh build of its target
# ---------------------------------------------------------------------------

def _tenants4():
    return [(f"t{t}",) + _tenant(1000 + 17 * t, 40) for t in range(4)]


def _stream(tenants, per=24):
    reqs = []
    for i, (tid, _, _, p) in enumerate(tenants):
        f, _ = jsvc_lib.sample_tenant_queries(7 + i, p, per, noise=0.9)
        reqs += [tsvc_lib.ClassifyRequest(tid, np.asarray(f[j]))
                 for j in range(per)]
    return reqs


def _fresh(spec, tenants):
    svc = TService.from_spec(spec, device="cpu")
    for tid, bank, head, _ in tenants:
        svc.register_tenant(tid, bank, head=head)
    return svc


def _spec(shards, backend="kernel"):
    return _snap_spec(shards)._replace(engine=EngineConfig(
        backend=backend, margin=True))


def test_reconfigure_1_to_2_drained():
    tenants = _tenants4()
    reqs = _stream(tenants)
    with port_mesh((1, 2)):
        svc = _fresh(_spec(1), tenants)
        assert context.get_mesh().shape == {"data": 2, "model": 1}
        base = _sig(svc.serve(reqs))
        for r in reqs[:16]:
            svc.submit(r)
        report = svc.reconfigure(_spec(2))
        assert _sig(report.drained) == base[:16]
        assert svc.registry.bank_shards == tmatch.bank_shards_in_mesh() == 2
        assert any("resharded" in a for a in report.actions)
        got = _sig(svc.serve(reqs))
        fresh = _sig(_fresh(_spec(2), tenants).serve(reqs))
    assert got == base == fresh
    assert any(esc for _, _, esc, _ in base)


def test_rolling_reshard_2_to_4_no_drain_and_stale_buffer():
    tenants = _tenants4()
    reqs = _stream(tenants)
    with port_mesh((1, 4)):
        svc = _fresh(_spec(2), tenants)
        base = _sig(svc.serve(reqs))
        drained_svc = _fresh(_spec(2), tenants)
        for r in reqs[:16]:
            svc.submit(r)
            drained_svc.submit(r)
        report = svc.rolling_reshard(_spec(4))
        assert report.drained == [] and svc.scheduler.qsize == 16
        assert svc.registry.bank_shards == tmatch.bank_shards_in_mesh() == 4
        flipped = []
        while svc.scheduler.qsize:
            flipped.extend(svc.step())
        drained = drained_svc.reconfigure(_spec(4))
        assert _sig(flipped) == _sig(drained.drained) == base[:16]
        assert _sig(svc.serve(reqs)) == base == \
            _sig(_fresh(_spec(4), tenants).serve(reqs))
        # churn between prepare and flip makes the buffer stale
        prep = reshard_lib.prepare(svc, _spec(2))
        svc.evict_tenant("t3")
        assert prep.stale
        with pytest.raises(RegistryError, match="stale"):
            svc.rolling_reshard(prep.spec, prepared=prep)
        assert svc.registry.bank_shards == 4
        svc_report = svc.rolling_reshard(_spec(2))  # re-prepared: flips
    assert svc_report.spec.mesh.bank_shards == 2
    # only a mesh change rides the flip
    with pytest.raises(ValueError, match="rolling reshard only covers"):
        reshard_lib.prepare(svc, _spec(2)._replace(
            scheduler=tspec.SchedulerSpec(slots=32)))


def test_device_loss_4_to_3_and_heal():
    """A forced 1x4 mesh at 4 shards loses device 3: the survivors form 3
    shards (capacity re-aligned to 48-row multiples, the all-gather fold),
    serving what a fresh 3-shard build serves; the heal reshards back to
    4 over the full device list."""
    tenants = _tenants4()
    reqs = _stream(tenants)
    with port_mesh((1, 4)):
        svc = _fresh(_spec(4), tenants)
        base = _sig(svc.serve(reqs))
        report = svc.handle_device_loss([3])
        target = svc.spec  # 3 shards, its capacity rounded up to 288 rows
        assert target.registry.initial_classes == 288
        assert svc.registry.bank_shards == 3
        assert svc.registry.capacity_classes % 48 == 0
        assert any("device loss" in a for a in report.actions)
        assert svc.health()["devices"] == 3
        mesh = context.get_mesh()
        assert mesh.shape == {"data": 1, "model": 3}
        plan, _ = tmatch.plan_for(batch=16,
                                  num_classes=svc.registry.capacity_classes)
        assert plan.bank_shards == 3 and plan.reduce == "allgather"
        assert _sig(svc.serve(reqs)) == base
        with pytest.raises(ValueError, match="out of range"):
            svc.handle_device_loss([7])
        heal = svc.restore_devices()
        assert svc.registry.bank_shards == 4 and svc.health()["devices"] == 4
        assert any("restored full fleet" in a for a in heal.actions)
        assert _sig(svc.serve(reqs)) == base
    with port_mesh((1, 3)):
        assert _sig(_fresh(target, tenants).serve(reqs)) == base


def test_snapshot_at_2_restored_at_4(tmp_path, _jax_jobs):
    with port_mesh((1, 4)):
        svc, report = TService.restore(
            Checkpointer(_jax_jobs["port_dir"]),
            mesh=tspec.MeshSpec(bank_shards=4), device="cpu")
        assert report.resharded and report.tenants == 4
        assert svc.registry.bank_shards == tmatch.bank_shards_in_mesh() == 4
        assert any("resharded" in a for a in report.actions)
        got = _serve_snap(svc)
        same, report = TService.restore(Checkpointer(_jax_jobs["port_dir"]),
                                        device="cpu")
        assert not report.resharded and same.registry.bank_shards == 2
        assert _serve_snap(same) == got
    assert got == _jax_jobs["port_sig"]


def test_autopilot_escalates_through_the_flip():
    """Under a forced 1x2 mesh with the spec owning it, a full one-shard
    bank makes the policy escalate to 2 shards: the autopilot prepares
    the shadow bank and flips it at the next tick, with the mesh
    reinstalled and the same answers."""
    from repro_torch import fleet as tfleet

    spec = tspec.ServiceSpec(
        registry=tspec.RegistrySpec(num_features=N),
        engine=EngineConfig(backend="kernel", margin=True),
        mesh=tspec.MeshSpec(install=True),
        scheduler=tspec.SchedulerSpec(slots=16),
        cascade=tspec.CascadeSpec(tau=6.0, tau_units="count"))
    tenants = [(f"t{t}",) + _tenant(50 + t, 10) for t in range(8)]
    reqs = _stream(tenants, per=4)
    with port_mesh((1, 2)):
        svc = _fresh(spec, tenants)
        base = _sig(svc.serve(reqs))
        view = tfleet.view_of(svc)
        assert view.devices == 2
        assert tfleet.explain(view)[0] == "escalate_shards"
        pilot = tfleet.Autopilot(svc, policy=tfleet.PolicySpec(
            interval=1, hysteresis=2))
        assert [pilot.observe_tick() for _ in range(3)] == [
            None, "escalate_shards", "buffer_flip"]
        assert svc.registry.bank_shards == tmatch.bank_shards_in_mesh() == 2
        assert _sig(svc.serve(reqs)) == base


def test_chaos_replay_loses_a_shard_and_heals():
    cfg = ttraces.TraceConfig(seed=5, tenants=4, classes=10, num_features=N,
                              requests=96, burst=24, calm=4, phase_ticks=1)
    spec = tbench.make_spec(8, requests=cfg.requests, bank_shards=4,
                            install_mesh=True)
    sigs = {}
    with port_mesh((1, 4)):
        for name, chaos in (("clean", None),
                            ("loss", ttraces.ChaosPlan(
                                lose_devices_at=2, lose=(3,),
                                heal_at_tick=4))):
            svc = TService.from_spec(spec, device="cpu")
            pool = ttraces.TenantPool(cfg)
            pool.register_all(svc)
            svc, stats = ttraces.replay(svc, ttraces.make_trace(cfg), pool,
                                        chaos=chaos)
            probe = [pool.request(t % 4, 555_000 + t) for t in range(32)]
            sigs[name] = (stats, tbench._signature(svc.serve(probe)),
                          svc.registry.bank_shards)
    (_, clean, _), (loss, got, shards) = sigs["clean"], sigs["loss"]
    assert loss["post_loss_bank_shards"] == 3 and shards == 4
    assert loss["device_loss_downtime_ms"] is not None
    assert got == clean


# ---------------------------------------------------------------------------
# against JAX's sharded service (subprocesses)
# ---------------------------------------------------------------------------

def _legacy_serve(layout, slots, churn, calls):
    svc = tsvc_lib.ACAMService(
        N, config=tsvc_lib.ServiceConfig(slots=slots, margin_tau=6.0),
        device="cpu")
    protos = {}
    for t, classes in enumerate(LAYOUTS[layout]):
        bank, head, p = _tenant(1000 + 17 * t, classes)
        svc.register_tenant(f"t{t}", bank, head=head)
        protos[f"t{t}"] = p
    if churn:
        svc.evict_tenant("t1")
        bank, head, p = _tenant(2000, 40)
        svc.register_tenant("tx", bank, head=head)
        protos["tx"] = p
        del protos["t1"]
    reqs = []
    for i, (tid, p) in enumerate(sorted(protos.items())):
        f, _ = jsvc_lib.sample_tenant_queries(7 + i, p, 40, noise=0.9)
        reqs += [tsvc_lib.ClassifyRequest(tid, np.asarray(f[j]))
                 for j in range(40)]
    before = len(calls)
    out = _sig(svc.serve(reqs))
    stats = svc.scheduler.stats
    assert len(calls) - before == stats.ticks == stats.classify_dispatches
    return svc, out, {t: svc.registry.get(t).offset for t in protos}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_service_matches_jax_sharded(_jax_jobs, shape, monkeypatch):
    """The JAX forced-2x2 service scenario (edge-packed and
    straddle-skipping tenant layouts, churn across a shard): the port at 2
    shards (2x2) and 4 shards (1x4, bank_shards inferred from the mesh by
    the legacy constructor) answers as JAX's sharded service does, with
    one engine call per tick."""
    calls = []
    orig = tmatch.MatchEngine.classify_serve

    def counting(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(tmatch.MatchEngine, "classify_serve", counting)
    want = _jax_jobs["service"].result()
    for layout in LAYOUTS:
        for slots, churn in ((64, False), (16, True)):
            with port_mesh(shape):
                svc, got, offsets = _legacy_serve(layout, slots, churn,
                                                  calls)
                assert svc.registry.bank_shards == shape[1]
            key = f"{layout}_{slots}_{churn}"
            assert got == want[f"svc_{key}"], key
            if shape == (2, 2):
                assert offsets == want[f"offsets_{key}"]
            rps = svc.registry.rows_per_shard
            for t in svc.registry._tenants:
                e = svc.registry.get(t)
                assert e.offset // rps == (e.offset + e.c_bucket - 1) // rps


def test_rolling_flip_matches_jax(_jax_jobs):
    from repro_torch.fleet import FleetManifest, TenantSpec

    spec = _spec(1)
    want = _jax_jobs["service"].result()
    protos = {f"t{t}": jsvc_lib.make_synthetic_tenant(
        1000 + 17 * t, num_classes=40, num_features=N)[2] for t in range(4)}
    reqs = []
    for i, (tid, p) in enumerate(sorted(protos.items())):
        f, _ = jsvc_lib.sample_tenant_queries(7 + i, p, 24, noise=0.9)
        reqs += [tsvc_lib.ClassifyRequest(tid, np.asarray(f[j]))
                 for j in range(24)]
    with port_mesh((2, 2)):
        svc = TService.from_spec(spec, device="cpu")
        svc.apply_manifest(FleetManifest(tenants=tuple(
            TenantSpec(f"t{t}", seed=1000 + 17 * t, num_classes=40)
            for t in range(4))))
        base = _sig(svc.serve(reqs))
        for r in reqs[:16]:
            svc.submit(r)
        prep = reshard_lib.prepare(svc, spec._replace(
            mesh=tspec.MeshSpec(bank_shards=2)))
        report = svc.rolling_reshard(prep.spec, prepared=prep)
        assert report.drained == []
        assert context.get_mesh().shape == {"data": 2, "model": 2}
        flipped = []
        while svc.scheduler.qsize:
            flipped.extend(svc.step())
        full = _sig(svc.serve(reqs))
    assert base == want["flip_base"]
    assert _sig(flipped) == want["flip_queued"] == base[:16]
    assert full == want["flip_full"] == base
    assert report.tenants_moved == want["flip_moved"]


def test_snapshots_across_packages_and_shard_counts(_jax_jobs):
    """JAX's 2-shard snapshot restores in the port at 4 shards, the port's
    in JAX at 4; both serve what JAX's 2-shard service served."""
    want = _jax_jobs["service"].result()
    with port_mesh((1, 4)):
        svc, report = TService.restore(Checkpointer(_jax_jobs["jax_dir"]),
                                       mesh=tspec.MeshSpec(bank_shards=4),
                                       device="cpu")
        got = _serve_snap(svc)
    assert report.resharded and svc.registry.bank_shards == 4
    assert got == want["snap_sig"] == want["port_snap_at4"] \
        == _jax_jobs["port_sig"]
    assert want["port_snap_report"] == [True, 4, 4]


def test_bench_rows_match_jax(_jax_jobs, monkeypatch):
    """The serving bench's sharded rows under ``REPRO_FORCE_MESH=1x2``:
    every field but the host-clock timings equals the JAX row."""
    monkeypatch.setenv("REPRO_FORCE_MESH", "1x2")
    got = {"scaling": tbench.bank_scaling_sweep(smoke=True, device="cpu"),
           "reshard": tbench.reshard_bench(device="cpu"),
           "autopilot": tbench.autopilot_bench(smoke=True, device="cpu"),
           "chaos": tbench.chaos_bench(smoke=True, device="cpu")}
    want = _jax_jobs["bench"].result()
    assert len(got["scaling"]) == len(want["scaling"]) == 4
    for name in got:
        rows_g = got[name] if isinstance(got[name], list) else [got[name]]
        rows_w = want[name] if isinstance(want[name], list) \
            else [want[name]]
        for g, w in zip(rows_g, rows_w):
            assert set(g) == set(w), name
            for key in w:
                if key not in TIMINGS:
                    assert g[key] == w[key], (name, key)
    assert got["chaos"]["bank_sharding"] == got["reshard"]["bank_sharding"] \
        == got["autopilot"]["bank_sharding"] == 2
    assert got["autopilot"]["flip_downtime_ms"] < \
        got["autopilot"]["drained_downtime_ms"]
    # and none of them without a forced mesh
    monkeypatch.delenv("REPRO_FORCE_MESH")
    assert tbench.reshard_bench(device="cpu") is None
    assert tbench.autopilot_bench(device="cpu") is None
    assert torch.device("cpu") in context.devices("cpu")
