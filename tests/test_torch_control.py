"""The port's control plane against the JAX package's: the registry's
durable state and compaction, snapshots across the two packages, live
`reconfigure`, `health()`'s controller inputs, the deprecated constructor,
`register_backend`, the scheduler's stats, and the launcher's
``--manifest`` / ``--autopilot`` / ``--snapshot-dir`` / ``--restore``.

Both packages get the same numpy banks (the JAX synthetic tenants carried
across), so feature-count answers must be bit-identical; similarity
answers run on dyadic operands (identical preds, S and margins within
rtol 1e-5, atol 1e-6). The port runs on the CPU (``device="cpu"``).
"""
import dataclasses

import numpy as np
import pytest

from _torch_parity import dyadic, dyadic_windows, to_np
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core.templates import TemplateBank as JBank
from repro.launch import serve as jserve
from repro.serve import acam_service as jsvc_lib
from repro.serve import spec as jspec
from repro.serve.control import HybridService as JService
from repro.serve.registry import TemplateBankRegistry as JRegistry
from repro_torch import convert
from repro_torch import match as tmatch
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.templates import TemplateBank as TBank
from repro_torch.fleet import FleetManifest, TenantSpec
from repro_torch.launch import serve as tserve
from repro_torch.serve import acam_service as tsvc_lib
from repro_torch.serve import spec as tspec
from repro_torch.serve.control import HybridService as TService
from repro_torch.serve.control import ReconfigureError
from repro_torch.serve.registry import TemplateBankRegistry as TRegistry

N = 64
TENANTS = 3


@pytest.fixture(autouse=True)
def jax_mesh_cleared():
    """Without --spec the JAX launcher installs its serving mesh process-
    wide, and a spec that installs its mesh installs the port's; clear both
    after each test so later test files in this worker (the JAX LM's,
    `tests/test_lm_decode.py`; the port's, `tests/test_torch_deepseek_v3.py`)
    see none."""
    from repro.distributed import context
    from repro_torch.distributed import context as port_context

    yield
    context.clear()
    port_context.clear()


def _spec(m, backend="kernel", slots=16, tau=6.0, **engine):
    return m.ServiceSpec(
        registry=m.RegistrySpec(num_features=N),
        engine=m.EngineConfig(backend=backend, margin=True, **engine),
        mesh=m.MeshSpec(install=False),
        scheduler=m.SchedulerSpec(slots=slots),
        cascade=m.CascadeSpec(tau=tau, tau_units="count"))


def _tenants(seed=10):
    """JAX synthetic tenants as numpy: [(bank arrays, head, protos)]."""
    out = []
    for i in range(TENANTS):
        bank, head, p = jsvc_lib.make_synthetic_tenant(
            seed + i, num_classes=6 + 4 * i, k=1 + i % 2, num_features=N)
        out.append((tuple(to_np(a) for a in bank),
                    (np.array(head[0]), np.array(head[1])), p))
    return out


def _populate(svc, tenants, port: bool):
    for i, (arrays, head, _) in enumerate(tenants):
        bank = (convert.bank_from_numpy(*arrays, device="cpu") if port
                else JBank(*arrays))
        svc.register_tenant(f"t{i}", bank, head=head)


def _stream(tenants, n, seed=0, noise=0.9):
    out = []
    for i in range(n):
        tid = i % TENANTS
        f, _ = jsvc_lib.sample_tenant_queries(seed + i, tenants[tid][2], 1,
                                              noise=noise)
        out.append((f"t{tid}", f[0]))
    return out


def _serve(svc, lib, stream):
    return svc.serve([lib.ClassifyRequest(t, f) for t, f in stream])


def _key(r):
    return (r.request_id, r.tenant_id, r.pred, r.margin, r.escalated,
            r.shed, r.energy_j, r.error, r.score)


def _same(jr, tr):
    assert [_key(r) for r in tr] == [_key(r) for r in jr]


# ---------------------------------------------------------------------------
# the registry's durable state
# ---------------------------------------------------------------------------

def _bank_arrays(rng, c, k):
    templates = (rng.random((c, k, N)) > 0.5).astype(np.float32)
    lower, upper = dyadic_windows(rng, c, k, N)
    return (templates, lower, upper, rng.random((c, k)) < 0.8,
            dyadic(rng, (N,)))


def _churn(reg, bank_cls):
    """One register / update / evict sequence past both initial
    capacities (classes 128 -> 512, tenants 8 -> 16)."""
    rng = np.random.default_rng(0)

    def bank(c, k):
        return bank_cls(*_bank_arrays(rng, c, k))

    reg.register("a", bank(10, 1))
    reg.register("b", bank(40, 2))
    reg.register("c", bank(12, 2))
    reg.update("a", bank(20, 1))  # outgrows its bucket: relocates
    reg.update("b", bank(30, 2))  # fits: in place
    reg.evict("c")
    reg.register("d", bank(70, 2))  # grows the class capacity
    for i in range(8):
        reg.register(f"s{i}", bank(3, 1))  # grows the tenant capacity
    for name in ("s1", "s4", "d"):
        reg.evict(name)
    return reg


def _same_state(treg, jreg):
    (ta, tm), (ja, jm) = treg.snapshot_state(), jreg.snapshot_state()
    assert tm == jm
    assert set(ta) == set(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_registry_state_matches_jax():
    jreg = _churn(JRegistry(N), JBank)
    treg = _churn(TRegistry(N, device="cpu"), TBank)
    _same_state(treg, jreg)
    assert treg.stats() == jreg.stats()
    assert treg.shard_rows_used() == jreg.shard_rows_used()
    assert treg.rows_per_shard == jreg.rows_per_shard
    assert treg.capacity_classes == jreg.capacity_classes == 512


def test_compact_matches_jax():
    jreg = _churn(JRegistry(N), JBank)
    treg = _churn(TRegistry(N, device="cpu"), TBank)
    live = sorted(e for e in ("a", "b", "s0", "s2", "s3", "s5", "s6", "s7"))
    before = {t: treg.bank_of(t) for t in live}
    device_bank = treg.device_bank()
    freed = treg.compact()
    assert freed == jreg.compact() > 0
    _same_state(treg, jreg)
    assert treg.device_bank() is not device_bank  # rebuilt at the new shape
    assert treg.device_bank().templates.shape[0] == treg.capacity_classes
    for t in live:
        got, jgot = treg.bank_of(t), jreg.bank_of(t)
        for f in TBank._fields:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(before[t], f))
            np.testing.assert_array_equal(getattr(got, f),
                                          to_np(getattr(jgot, f)))
    assert treg.compact() == jreg.compact() == 0  # already minimal


def test_load_state_across_packages():
    jreg = _churn(JRegistry(N), JBank)
    treg = _churn(TRegistry(N, device="cpu"), TBank)
    t_from_j, j_from_t = TRegistry(N, device="cpu"), JRegistry(N)
    t_from_j.load_state(*jreg.snapshot_state())
    j_from_t.load_state(*treg.snapshot_state())
    j_from_j = JRegistry(N)  # load_state bumps the generation in both
    j_from_j.load_state(*jreg.snapshot_state())
    _same_state(t_from_j, j_from_j)
    _same_state(t_from_j, j_from_t)
    np.testing.assert_array_equal(to_np(t_from_j.device_bank().templates),
                                  to_np(jreg.device_bank().templates))
    # a super-bank in two shards loads with its shard count, both ways
    jreg2 = _churn(JRegistry(N, bank_shards=2), JBank)
    treg2 = _churn(TRegistry(N, bank_shards=2, device="cpu"), TBank)
    _same_state(treg2, jreg2)
    t_from_j2, j_from_t2 = TRegistry(N, device="cpu"), JRegistry(N)
    t_from_j2.load_state(*jreg2.snapshot_state())
    j_from_t2.load_state(*treg2.snapshot_state())
    assert t_from_j2.bank_shards == j_from_t2.bank_shards == 2
    _same_state(t_from_j2, j_from_t2)
    assert t_from_j2.shard_rows_used() == jreg2.shard_rows_used()


# ---------------------------------------------------------------------------
# snapshots across the two packages
# ---------------------------------------------------------------------------

def test_jax_snapshot_restores_in_the_port(tmp_path):
    tenants = _tenants()
    jsvc = JService.from_spec(_spec(jspec))
    _populate(jsvc, tenants, port=False)
    _serve(jsvc, jsvc_lib, _stream(tenants, 20, seed=1))
    jsvc.snapshot(JCheckpointer(tmp_path))
    tsvc, report = TService.restore(Checkpointer(tmp_path), device="cpu")
    assert report.tenants == TENANTS and report.step == 0
    assert tsvc.spec.to_json() == jsvc.spec.to_json()
    stream = _stream(tenants, 40, seed=2)
    _same(_serve(jsvc, jsvc_lib, stream), _serve(tsvc, tsvc_lib, stream))
    np.testing.assert_array_equal(tsvc.head_of("t1")[0],
                                  jsvc.head_of("t1")[0])


def test_port_snapshot_restores_in_jax(tmp_path):
    tenants = _tenants(20)
    tsvc = TService.from_spec(_spec(tspec), device="cpu")
    _populate(tsvc, tenants, port=True)
    tsvc.retune_tenant("t2", margin_tau=3.0)
    _serve(tsvc, tsvc_lib, _stream(tenants, 20, seed=3))
    assert tsvc.snapshot(Checkpointer(tmp_path), blocking=False) == 0
    tsvc.snapshot(Checkpointer(tmp_path))  # step 1, after step 0's write
    jsvc, report = JService.restore(JCheckpointer(tmp_path))
    assert report.step == 1
    stream = _stream(tenants, 40, seed=4)
    _same(_serve(jsvc, jsvc_lib, stream), _serve(tsvc, tsvc_lib, stream))


def test_similarity_snapshot_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    js = _spec(jspec, method="similarity")._replace(
        cascade=jspec.CascadeSpec(tau=7e-4, tau_units="fraction"))
    jsvc = JService.from_spec(js)
    protos = []
    for i in range(TENANTS):
        c = 5 + 3 * i
        arrays = _bank_arrays(rng, c, 2)
        head = (dyadic(rng, (N, c)), dyadic(rng, (c,)))
        jsvc.register_tenant(f"t{i}", JBank(*arrays), head=head)
        protos.append(c)
    jsvc.snapshot(JCheckpointer(tmp_path / "jax"))
    tsvc, _ = TService.restore(Checkpointer(tmp_path / "jax"), device="cpu")
    tsvc.snapshot(Checkpointer(tmp_path / "port"))
    jback, _ = JService.restore(JCheckpointer(tmp_path / "port"))
    stream = [(f"t{i % TENANTS}", dyadic(rng, (N,))) for i in range(48)]
    jr = _serve(jsvc, jsvc_lib, stream)
    for other, lib in ((tsvc, tsvc_lib), (jback, jsvc_lib)):
        got = _serve(other, lib, stream)
        assert [r.pred for r in got] == [r.pred for r in jr]
        np.testing.assert_allclose([r.margin for r in got],
                                   [r.margin for r in jr],
                                   rtol=1e-5, atol=1e-6)
    assert 0 < sum(r.escalated for r in jr) < len(jr)


# ---------------------------------------------------------------------------
# live reconfigure
# ---------------------------------------------------------------------------

TRANSITIONS = {
    "slots": dict(scheduler=dict(slots=8)),
    "compose": dict(engine=dict(serve_fusion="compose")),
    "similarity": dict(engine=dict(method="similarity")),
    "reference": dict(engine=dict(backend="reference")),
    "device": dict(engine=dict(backend="device")),
    "tau": dict(cascade=dict(tau=12.0)),
}


def _apply(spec, change):
    return spec._replace(**{block: getattr(spec, block)._replace(**kw)
                            for block, kw in change.items()})


@pytest.mark.parametrize("name", sorted(TRANSITIONS))
def test_reconfigure_serves_as_a_fresh_build(name):
    tenants = _tenants(30)
    old = _spec(tspec)
    new = _apply(old, TRANSITIONS[name])

    def fresh(spec):
        svc = TService.from_spec(spec, device="cpu")
        _populate(svc, tenants, port=True)
        return svc

    svc = fresh(old)
    pending = _stream(tenants, 24, seed=6)
    for t, f in pending:
        svc.submit(tsvc_lib.ClassifyRequest(t, f))
    report = svc.reconfigure(new)
    assert report.spec == new == svc.spec and report.actions
    assert [_key(r) for r in report.drained] == \
        [_key(r) for r in _serve(fresh(old), tsvc_lib, pending)]
    probe = _stream(tenants, 40, seed=7)
    got = [_key(r)[1:] for r in _serve(svc, tsvc_lib, probe)]
    assert got == [_key(r)[1:] for r in _serve(fresh(new), tsvc_lib, probe)]
    # the JAX control plane logs the same transition
    jsvc = JService.from_spec(_spec(jspec))
    jreport = jsvc.reconfigure(_apply(_spec(jspec), TRANSITIONS[name]))
    assert report.actions == jreport.actions
    assert svc.scheduler.stats.slots == new.scheduler.slots


def test_reconfigure_refusals_and_noop():
    svc = TService.from_spec(_spec(tspec), device="cpu")
    _populate(svc, _tenants(), port=True)
    before = svc.spec
    for field, value in (("num_features", 32), ("k_max", 3),
                         ("class_bucket", 8)):
        with pytest.raises(ReconfigureError, match=field):
            svc.reconfigure(before._replace(
                registry=before.registry._replace(**{field: value})))
    # an installed mesh of one CPU device cannot hold two shards: refused
    # before anything changes
    with pytest.raises(ReconfigureError, match="does not divide"):
        svc.reconfigure(before._replace(
            mesh=before.mesh._replace(bank_shards=2, install=True)))
    assert svc.spec == before and svc.registry.bank_shards == 1
    report = svc.reconfigure(before)
    assert report.actions == () and report.drained == [] \
        and report.downtime_s == 0.0
    assert svc.compact_registry() == 128 - TENANTS * 16
    assert svc.compact_registry() == 0


# ---------------------------------------------------------------------------
# health, the deprecated constructor, backends, the scheduler's stats
# ---------------------------------------------------------------------------

FLEET_FIELDS = ("tenants", "bank_shards", "capacity_classes",
                "rows_per_shard", "shard_rows_used", "fused_rows_per_shard",
                "vmem_budget_rows", "slots", "queue_depth",
                "energy_backend_j", "energy_frontend_j")


def test_health_carries_the_controller_inputs():
    tenants = _tenants()
    jsvc = JService.from_spec(_spec(jspec))
    tsvc = TService.from_spec(_spec(tspec), device="cpu")
    _populate(jsvc, tenants, port=False)
    _populate(tsvc, tenants, port=True)
    stream = _stream(tenants, 30, seed=8)
    _same(_serve(jsvc, jsvc_lib, stream), _serve(tsvc, tsvc_lib, stream))
    jh, th = jsvc.health(), tsvc.health()
    for key in FLEET_FIELDS:
        assert th[key] == jh[key], key
    assert th["devices"] == 1
    assert th["rolling_batch_fill"] == jh["rolling_batch_fill"]


def test_legacy_constructor_and_from_legacy():
    config = tsvc_lib.ServiceConfig(slots=8, method="similarity",
                                    margin_tau=5.0, max_queue=100)
    jconfig = jsvc_lib.ServiceConfig(**dataclasses.asdict(config))
    tl = tspec.from_legacy(N, config=config, k_max=3, backend="kernel")
    jl = jspec.from_legacy(N, config=jconfig, k_max=3, backend="kernel")
    assert tl.to_json() == jl.to_json()
    svc = tsvc_lib.ACAMService(N, config=config, k_max=3, backend="kernel",
                               device="cpu")
    assert svc.spec == tl and svc.config == config
    assert svc.spec.tau_scale() == 1.0 / N  # similarity margins: fractions
    bank, head, protos = tsvc_lib.make_synthetic_tenant(3, num_features=N)
    svc.register_tenant("t", bank, head=head)
    f, _ = tsvc_lib.sample_tenant_queries(1, protos, 4)
    assert len(svc.serve([tsvc_lib.ClassifyRequest("t", x) for x in f])) == 4


def test_register_backend():
    class Counting(tmatch.ReferenceBackend):
        name = "counting"
        calls = 0

        def feature_count_scores(self, *args, **kw):
            Counting.calls += 1
            return super().feature_count_scores(*args, **kw)

    with pytest.raises(ValueError, match="auto"):
        tmatch.register_backend("auto", Counting)
    tmatch.register_backend("counting", Counting)
    try:
        assert "counting" in tmatch.backend_names()
        spec = _spec(tspec, backend="counting").validate()
        svc = TService.from_spec(spec, device="cpu")
        tenants = _tenants()
        _populate(svc, tenants, port=True)
        ref = TService.from_spec(_spec(tspec, backend="reference"),
                                 device="cpu")
        _populate(ref, tenants, port=True)
        stream = _stream(tenants, 12, seed=9)
        _same(_serve(ref, tsvc_lib, stream), _serve(svc, tsvc_lib, stream))
        assert Counting.calls > 0
    finally:
        from repro_torch.match import backends

        backends._REGISTRY.pop("counting", None)
        backends.backend_for.cache_clear()


def test_scheduler_stats_and_engine_swap():
    tenants = _tenants()
    jsvc = JService.from_spec(_spec(jspec, slots=7))
    tsvc = TService.from_spec(_spec(tspec, slots=7), device="cpu")
    _populate(jsvc, tenants, port=False)
    _populate(tsvc, tenants, port=True)
    stream = _stream(tenants, 30, seed=11)
    _same(_serve(jsvc, jsvc_lib, stream), _serve(tsvc, tsvc_lib, stream))
    td, jd = tsvc.scheduler.stats.as_dict(), jsvc.scheduler.stats.as_dict()
    td.pop("tick_time_s"), jd.pop("tick_time_s")
    assert td == jd and tsvc.scheduler.stats.occupancy == \
        jsvc.scheduler.stats.occupancy
    sched = tsvc.scheduler
    assert (sched.method, sched.alpha) == ("feature_count", 1.0)
    sched.set_engine(sched.engine_config._replace(method="similarity",
                                                  alpha=0.5))
    assert (sched.method, sched.alpha) == ("similarity", 0.5)


# ---------------------------------------------------------------------------
# the launcher's control-plane flags
# ---------------------------------------------------------------------------

LAUNCH = ["--workload", "acam", "--tenants", "3", "--requests", "48",
          "--slots", "16", "--classes", "6"]


def _preds(out):
    return [(r.tenant_id, r.pred, r.margin, r.escalated)
            for r in out["responses"]]


def test_launcher_snapshot_then_restore(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    first = tserve.main(LAUNCH + ["--snapshot-dir", ckpt], device="cpu")
    again = tserve.main(LAUNCH + ["--snapshot-dir", ckpt, "--restore"],
                        device="cpu")
    out = capsys.readouterr().out
    assert "restored step 0: 3 tenants" in out
    assert "step 1 (restart with --restore)" in out
    assert _preds(again) == _preds(first)
    assert again["completed"] == 48
    # a snapshot the JAX launcher wrote restores in the port's, which then
    # serves the same stream as the JAX run did
    jfirst = jserve.main(LAUNCH + ["--snapshot-dir", str(tmp_path / "jax")])
    from_jax = tserve.main(LAUNCH + ["--snapshot-dir", str(tmp_path / "jax"),
                                     "--restore"], device="cpu")
    for key in ("accuracy", "completed", "escalated", "classify_dispatches"):
        assert from_jax[key] == jfirst[key], key
    with pytest.raises(SystemExit, match="snapshot-dir"):
        tserve.main(LAUNCH + ["--restore"], device="cpu")


def test_launcher_manifest(tmp_path, capsys):
    manifest = FleetManifest(tenants=tuple(
        TenantSpec(f"m{t}", seed=70 + t, num_classes=5 + t, k=1 + t % 2,
                   tau=4.0 if t == 1 else None) for t in range(3)))
    path = tmp_path / "fleet.json"
    path.write_text(manifest.to_json())
    got = tserve.main(LAUNCH + ["--manifest", str(path)], device="cpu")
    want = jserve.main(LAUNCH + ["--manifest", str(path)])
    out = capsys.readouterr().out
    assert out.count("manifest applied: +3 added, -0 evicted") == 2
    assert got["completed"] == want["completed"] == 48
    assert got["classify_dispatches"] == want["classify_dispatches"]
    assert abs(got["accuracy"] - want["accuracy"]) <= 2 / 48


def test_launcher_autopilot(capsys):
    got = tserve.main(LAUNCH + ["--autopilot"], device="cpu")
    plain = tserve.main(LAUNCH, device="cpu")
    out = capsys.readouterr().out
    assert "autopilot:" in out
    assert got["completed"] == 48 and isinstance(got["autopilot"], list)
    assert sorted(r.request_id for r in got["responses"]) == \
        list(range(1, 49))
    assert sorted(_preds(got)) == sorted(_preds(plain))


def test_serve_batched_example():
    from repro_torch.examples import serve_batched

    lm = serve_batched.main(["--workload", "lm", "--requests", "5",
                             "--max-new", "3"], device="cpu")
    assert lm["tokens"] == 15 and lm["stats"]["requests"] == 5
    out = serve_batched.main(["--workload", "acam", "--fast", "--tenants",
                              "2", "--batch-size", "32"], device="cpu")
    assert out["completed"] == 250 + 250 // 4  # the test set + 1 co-tenant
    assert np.isfinite(out["accuracy"]) and 0 <= out["escalation_rate"] <= 1
    assert out["slots"] == 32
