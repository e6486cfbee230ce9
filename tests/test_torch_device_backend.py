"""The port's device-physics backend (`repro_torch.match.DeviceBackend`)
against the JAX package's, on the CPU.

At ``sigma_program = 0`` every engine entry point (`classify`,
`classify_features`, `classify_features_margin`, `classify_serve`, the raw
scores) is bit-identical for both cells and both methods, on binary and
dyadic windows, with invalid rows, empty class windows and a NaN feature.
With noise, the JAX-drawn fields go through the port's noise step (torch
cannot draw threefry streams): windows within 2 ulp, decisions equal,
per-class scores within 1e-6. The Monte-Carlo sweep reproduces the JAX
package's semantics on the port's own draws. The served path (`classify_serve`,
the service and the launcher) is held against the JAX tick as the
scheduler runs it, under jit: XLA folds the sense chain's constants into
reciprocal products (and a 3T1R FMA), which the port's served path computes
too (`core.acam.sense_compiled`), so its margins agree bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import binary_bank, dyadic, t, to_np
from repro import match as jmatch
from repro.core import acam as ja
from repro.core.templates import TemplateBank as JBank
from repro.launch import serve as jserve
from repro.serve import acam_service as jsvc_lib
from repro.serve import spec as jspec
from repro.serve.control import HybridService as JService
from repro_torch import convert
from repro_torch import match as tmatch
from repro_torch.core import acam as ta
from repro_torch.core.templates import TemplateBank as TBank
from repro_torch.launch import serve as tserve
from repro_torch.serve import acam_service as tsvc_lib
from repro_torch.serve.control import HybridService as TService

N = 100  # 1/N inexact: the 3T1R quotient and the 6T4R chain round
SLOTS = 8
CELLS = ("6T4R", "3T1R")
METHODS = ("feature_count", "similarity")
KEYS = ("accuracy", "completed", "escalated", "classify_dispatches",
        "escalation_rate")


def _inputs(seed, b=16, c=10, k=2, windows="binary"):
    rng = np.random.default_rng(seed)
    bank = binary_bank(rng, c, k, N)
    if windows == "binary":
        lower = (rng.random((c, k, N)) > 0.5).astype(np.float32)
        upper = np.maximum((rng.random((c, k, N)) > 0.5).astype(np.float32),
                           lower)
    else:
        lower = dyadic(rng, (c, k, N), -8, 1)
        upper = lower + dyadic(rng, (c, k, N), 0, 9)
    bank.update(lower=lower, upper=upper,
                thresholds=dyadic(rng, (N,), -2, 3))
    feats = dyadic(rng, (b, N))
    feats[3, 7] = np.nan
    lo = rng.integers(0, max(c - 4, 1), size=b).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c).astype(np.int32)
    hi[0] = lo[0]  # empty window
    tau = np.full(b, 0.05, np.float32)
    tau[1] = -np.inf
    return dict(bank=bank, feats=feats,
                queries=(rng.random((b, N)) > 0.5).astype(np.float32),
                table=dyadic(rng, (SLOTS, N), -4, 5),
                slot=rng.integers(0, SLOTS, size=b).astype(np.int32),
                lo=lo, hi=hi, tau=tau)


def _banks(bank):
    fields = ("templates", "lower", "upper", "valid", "thresholds")
    return (JBank(*(jnp.asarray(bank[f]) for f in fields)),
            TBank(*(t(bank[f]) for f in fields)))


def _engines(method="feature_count", alpha=1.0, **dev):
    kw = dict(method=method, alpha=alpha, backend="device")
    noise = dev.pop("device_noise", "global")
    seed = dev.pop("seed", 0)
    return (jmatch.engine_for(**kw, device=ja.ACAMConfig(**dev), seed=seed,
                              device_noise=noise),
            tmatch.engine_for(**kw, device=ta.ACAMConfig(**dev), seed=seed,
                              device_noise=noise))


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("method,windows", [("feature_count", "binary"),
                                            ("similarity", "binary"),
                                            ("similarity", "dyadic")])
def test_entry_points_bit_identical_at_sigma_zero(cell, method, windows):
    x = _inputs(len(cell) + len(method), windows=windows)
    jbank, tbank = _banks(x["bank"])
    jeng, teng = _engines(method, alpha=0.37, cell=cell)
    jq, tq = jnp.asarray(x["queries"]), t(x["queries"])
    jf, tf = jnp.asarray(x["feats"]), t(x["feats"])
    _equal(teng.classify(tq, tbank), jeng.classify(jq, jbank))
    _equal(teng.classify_features(tf, tbank),
           jeng.classify_features(jf, jbank))
    _equal(teng.classify_features_margin(tf, tbank, t(x["lo"]), t(x["hi"])),
           jeng.classify_features_margin(jf, jbank, jnp.asarray(x["lo"]),
                                         jnp.asarray(x["hi"])))
    _equal(teng.classify_features_margin(tf, tbank),
           jeng.classify_features_margin(jf, jbank))
    # the served tick is held against the JAX tick as the scheduler runs
    # it, under jit (its compiled sense arithmetic, `sense_compiled`)
    _equal(teng.classify_serve(tf, t(x["table"]), t(x["slot"]), tbank,
                               t(x["lo"]), t(x["hi"]), t(x["tau"])),
           jax.jit(jeng.classify_serve)(
               jf, jnp.asarray(x["table"]), jnp.asarray(x["slot"]), jbank,
               jnp.asarray(x["lo"]), jnp.asarray(x["hi"]),
               jnp.asarray(x["tau"])))
    _equal([teng.scores(tq, tbank)], [jeng.scores(jq, jbank)])
    for valid in ("valid", None):
        jv = None if valid is None else jbank.valid
        tv = None if valid is None else tbank.valid
        _equal([teng.feature_count_scores(tq, tbank.templates, tv)],
               [jeng.feature_count_scores(jq, jbank.templates, jv)])
        _equal([teng.similarity_scores(tq, tbank.lower, tbank.upper, tv)],
               [jeng.similarity_scores(jq, jbank.lower, jbank.upper, jv)])


@pytest.mark.parametrize("cell", CELLS)
def test_decisions_match_reference_and_scores_are_fractions(cell):
    """The JAX package's own checks, on the port: at sigma 0 the device
    decides as the reference backend, per-class scores are count / N, and
    margins are the reference's over N; at alpha 0 the similarity
    reference is the in-window fraction the matchline senses."""
    x = _inputs(11, b=37)
    _, tbank = _banks(x["bank"])
    f = t(np.nan_to_num(x["feats"]))
    dev = tmatch.engine_for(backend="device", device=ta.ACAMConfig(cell=cell))
    ref = tmatch.engine_for(backend="reference")
    pred_d, pc_d = dev.classify_features(f, tbank)
    pred_r, pc_r = ref.classify_features(f, tbank)
    assert torch.equal(pred_d, pred_r)
    finite = torch.isfinite(pc_r)
    np.testing.assert_allclose(to_np(pc_d[finite]), to_np(pc_r[finite]) / N,
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(torch.isfinite(pc_d), finite)
    pred_d, _, m_d = dev.classify_features_margin(f, tbank)
    pred_r, _, m_r = ref.classify_features_margin(f, tbank)
    assert torch.equal(pred_d, pred_r)
    np.testing.assert_allclose(to_np(m_d), to_np(m_r) / N, rtol=1e-5,
                               atol=1e-6)
    q = t(x["queries"])
    sim = dict(method="similarity", alpha=0.0)
    pred_d, _ = tmatch.engine_for(backend="device", device=ta.ACAMConfig(
        cell=cell), **sim).classify(q, tbank)
    pred_r, _ = tmatch.engine_for(backend="reference", **sim).classify(
        q, tbank)
    assert torch.equal(pred_d, pred_r)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("noise", ["global", "per_shard"])
def test_noisy_decisions_equal_on_jax_fields(cell, method, noise):
    """sigma 0.05: the JAX device backend programs the bank from its seed's
    key (``fold_in(key, 0)`` under per-shard noise); the port's noise step
    on those fields gives windows within 2 ulp and the same decisions."""
    x = _inputs(23, b=32, windows="dyadic")
    jbank, tbank = _banks(x["bank"])
    cfg = dict(cell=cell, sigma_program=0.05, seed=4, device_noise=noise)
    jeng, teng = _engines(method, **cfg)
    jbe = jmatch.backend_for("device", jeng.config)
    tbe = tmatch.backend_for("device", teng.config)
    jprog = jbe.program_bank(jbank)
    lo, hi, valid = tbe._bank_rows(tbank)
    key = jax.random.PRNGKey(4)
    if noise == "per_shard":
        key = jax.random.fold_in(key, 0)
    k1, k2 = jax.random.split(key)
    z = [t(np.asarray(jax.random.normal(kk, lo.shape))) for kk in (k1, k2)]
    tlo, thi = ta.apply_noise(lo, hi, *ta.noise_factors(*z, 0.05))
    np.testing.assert_array_max_ulp(to_np(tlo), np.asarray(jprog.lower), 2)
    np.testing.assert_array_max_ulp(to_np(thi), np.asarray(jprog.upper), 2)
    tprog = ta.ProgrammedACAM(tlo, thi, valid,
                              ta.ACAMConfig(**jprog.config._asdict()))
    q = jnp.asarray(x["queries"])
    c, k = x["bank"]["valid"].shape
    jpred, jpc = jmatch.classify_scores(
        ja.sense(jprog, q).reshape(q.shape[0], c, k))
    tpred, tpc = tmatch.classify_scores(tbe._sense_rows(tprog, t(q), c, k))
    np.testing.assert_array_equal(to_np(tpred), np.asarray(jpred))
    np.testing.assert_allclose(to_np(tpc), np.asarray(jpc), rtol=0,
                               atol=1e-6)


def test_backend_properties_match_jax():
    for sigma in (0.0, 0.3):
        for noise in ("global", "per_shard"):
            jeng, teng = _engines(sigma_program=sigma, device_noise=noise)
            jbe = jmatch.backend_for("device", jeng.config)
            tbe = tmatch.backend_for("device", teng.config)
            assert tbe.name == jbe.name == "device"
            assert tbe.per_shard_noise == jbe.per_shard_noise
            assert tbe.supports_bank_sharding == jbe.supports_bank_sharding
            assert tbe.margin_cap(N) == jbe.margin_cap(N) == 1.0
    assert isinstance(tbe, tmatch.DeviceBackend)
    x = _inputs(3, c=10)
    _, tbank = _banks(x["bank"])
    with pytest.raises(ValueError, match="divisible by bank_shards"):
        tbe.program_bank(tbank, bank_shards=3)


def _sweep_case(seed, c, b, n=N):
    rng = np.random.default_rng(seed)
    bank = binary_bank(rng, c, 1, n, p_valid=1.0)
    lower = bank["templates"]
    tbank = TBank(t(bank["templates"]), t(lower), t(lower), t(bank["valid"]),
                  t(np.zeros(n, np.float32)))
    return t(rng.standard_normal((b, n)).astype(np.float32)), tbank


def test_sweep_shape_and_determinism():
    feats, bank = _sweep_case(31, 6, 40)
    eng = tmatch.engine_for(backend="device",
                            device=ta.ACAMConfig(sigma_program=0.4), seed=5)
    pred, per_class = eng.sweep_program_noise(feats, bank, 4, device="cpu")
    assert pred.shape == (4, 40) and pred.dtype == torch.int32
    assert per_class.shape == (4, 40, 6)
    assert not torch.allclose(per_class[0], per_class[1])  # draws differ
    pred2, per_class2 = eng.sweep_program_noise(feats, bank, 4, device="cpu")
    assert torch.equal(pred, pred2) and torch.equal(per_class, per_class2)
    # draw m is the engine programmed with split(prng_key(seed), 4)[m]
    be = tmatch.backend_for("device", eng.config)
    for m, key in enumerate(ta.split(ta.prng_key(5), 4)):
        p, pc = be.classify_features_keyed(feats, bank, key)
        assert torch.equal(p, pred[m]) and torch.equal(pc, per_class[m])
    # a different seed draws different arrays
    other = tmatch.engine_for(backend="device",
                              device=ta.ACAMConfig(sigma_program=0.4),
                              seed=6).sweep_program_noise(feats, bank, 4,
                                                          device="cpu")[1]
    assert not torch.equal(other, per_class)


def test_sweep_sigma_zero_collapses_to_ideal():
    feats, bank = _sweep_case(32, 5, 16)
    eng = tmatch.engine_for(backend="device")
    pred, per_class = eng.sweep_program_noise(feats, bank, 3, device="cpu")
    ideal_pred, ideal_pc = eng.classify_features(feats, bank)
    for m in range(3):
        assert torch.equal(pred[m], ideal_pred)
        assert torch.equal(per_class[m], ideal_pc)


def test_sweep_explicit_keys_and_backend_guard():
    feats, bank = _sweep_case(33, 4, 8)
    eng = tmatch.engine_for(backend="device",
                            device=ta.ACAMConfig(sigma_program=0.2))
    pred, pc = eng.sweep_program_noise(feats, bank, [7, 8, (7, 0), 9, 10],
                                       device="cpu")
    assert pred.shape == (5, 8)
    _, pc7 = eng.sweep_program_noise(feats, bank, [7], device="cpu")
    assert torch.equal(pc7[0], pc[0]) and not torch.equal(pc[0], pc[2])
    gens = [torch.Generator().manual_seed(s) for s in (1, 1)]
    _, pcg = eng.sweep_program_noise(feats, bank, gens, device="cpu")
    assert torch.equal(pcg[0], pcg[1])
    for backend in ("kernel", "reference", "auto"):
        with pytest.raises(ValueError, match="requires the device backend"):
            tmatch.engine_for(backend=backend).sweep_program_noise(
                feats, bank, 2, device="cpu")


def test_sweep_per_shard_noise_semantics():
    """`device_noise="per_shard"` programs one array per bank shard
    (``fold_in(key, s)``): deterministic, distinct from one array and from
    "global" noise; a class count the shards do not divide falls back to
    one array."""
    feats, bank = _sweep_case(34, 8, 20)
    dev = ta.ACAMConfig(sigma_program=0.3)
    tiled = tmatch.engine_for(backend="device", device=dev, seed=5,
                              device_noise="per_shard")
    mono = tmatch.engine_for(backend="device", device=dev, seed=5)
    assert tmatch.backend_for("device", tiled.config).supports_bank_sharding
    assert not tmatch.backend_for("device",
                                  mono.config).supports_bank_sharding

    def sweep(eng, **kw):
        return eng.sweep_program_noise(feats, bank, 3, device="cpu", **kw)[1]

    pc2 = sweep(tiled, bank_shards=2)
    assert torch.equal(pc2, sweep(tiled, bank_shards=2))
    pc1 = sweep(tiled, bank_shards=1)
    assert not torch.allclose(pc1, pc2)
    assert not torch.allclose(sweep(mono), pc2)
    assert not torch.allclose(sweep(mono), pc1)
    assert torch.equal(sweep(tiled, bank_shards=3), pc1)
    assert torch.equal(sweep(tiled), pc1)  # None: one card, one shard
    assert torch.equal(sweep(mono, bank_shards=2), sweep(mono))


def test_to_acam_matches_jax():
    from repro.core import hybrid as jhybrid
    from repro_torch.core import hybrid as thybrid

    x = _inputs(41, windows="dyadic")
    jbank, tbank = _banks(x["bank"])
    jhead = jhybrid.ACAMHead(bank=jbank, method="similarity")
    thead = thybrid.ACAMHead(bank=tbank, method="similarity")
    for cell in CELLS:
        cfg = dict(cell=cell, sigma_program=0.1)
        jp = jhead.to_acam(ja.ACAMConfig(**cfg))  # no key: no noise
        tp = thead.to_acam(ta.ACAMConfig(**cfg), device="cpu")
        _equal([tp.lower, tp.upper, tp.valid], [jp.lower, jp.upper, jp.valid])
        assert tuple(tp.config) == tuple(jp.config)
        q = np.nan_to_num(x["feats"])
        _equal([ta.sense(tp, t(q))], [ja.sense(jp, jnp.asarray(q))])
    noisy = thead.to_acam(ta.ACAMConfig(sigma_program=0.1), key=3,
                          device="cpu")
    want = ta.program(tbank.lower.reshape(20, N), tbank.upper.reshape(20, N),
                      tbank.valid.reshape(20), ta.ACAMConfig(
                          sigma_program=0.1), 3, device="cpu")
    assert torch.equal(noisy.lower, want.lower)
    assert not torch.equal(noisy.lower, tbank.lower.reshape(20, N))


def _spec_file(tmp_path, method, cell, sigma, tau):
    from repro.match.config import EngineConfig

    spec = jspec.ServiceSpec(
        registry=jspec.RegistrySpec(num_features=N),
        engine=EngineConfig(method=method, backend="device", margin=True,
                            device=ja.ACAMConfig(cell=cell,
                                                 sigma_program=sigma)),
        mesh=jspec.MeshSpec(install=False),
        scheduler=jspec.SchedulerSpec(slots=16),
        cascade=jspec.CascadeSpec(tau=tau, tau_units="count"))
    path = tmp_path / f"{method}_{cell}.json"
    path.write_text(spec.to_json())
    return str(path)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("method", METHODS)
def test_launcher_with_device_spec_matches_jax(tmp_path, capsys, cell,
                                               method):
    argv = ["--workload", "acam", "--spec",
            _spec_file(tmp_path, method, cell, 0.0, 14.5), "--tenants", "3",
            "--requests", "48", "--noise", "1.2", "--print-spec"]
    want = jserve.main(argv)
    jax_out = capsys.readouterr().out
    got = tserve.main(argv, device="cpu")
    torch_out = capsys.readouterr().out
    for key in KEYS:
        assert got[key] == want[key], key
    assert 0.0 < got["escalation_rate"] < 1.0
    assert all(r.error is None for r in got["responses"])
    spec_t = torch_out[:torch_out.index("acam service:")]
    assert spec_t == jax_out[:jax_out.index("acam service:")]
    assert json.loads(spec_t)["engine"]["device"]["cell"] == cell


def test_noisy_device_spec_serves_deterministically(tmp_path):
    argv = ["--workload", "acam", "--spec",
            _spec_file(tmp_path, "feature_count", "3T1R", 0.05, 14.5),
            "--tenants", "3", "--requests", "48", "--noise", "1.2"]
    a = tserve.main(argv, device="cpu")["responses"]
    b = tserve.main(argv, device="cpu")["responses"]
    assert [(r.pred, r.margin, r.escalated) for r in a] == \
        [(r.pred, r.margin, r.escalated) for r in b]


def test_default_device_backend_rescales_tau_like_pinned():
    """The launcher under a process default of "device" (no --backend)
    builds the same spec as ``--backend device``, so count-unit taus meet
    fraction-unit margins rescaled by 1/N, and the service serves the same
    answers; not every request escalates."""
    argv = ["--workload", "acam", "--tenants", "2", "--requests", "24",
            "--features", str(N), "--slots", "8", "--margin-tau", "14.5",
            "--noise", "1.2"]
    with tmatch.use_backend("device"):
        default = tserve.main(argv, device="cpu")
    pinned = tserve.main(argv + ["--backend", "device"], device="cpu")
    assert [(r.pred, r.margin, r.escalated) for r in default["responses"]] \
        == [(r.pred, r.margin, r.escalated) for r in pinned["responses"]]
    assert 0.0 < pinned["escalation_rate"] < 1.0


def test_service_stream_matches_jax():
    """One device spec, the same tenants and trace in both packages'
    `HybridService`: the same pred, escalation, shed and energy per
    response, and the same margins bit for bit (the served path computes
    the jitted JAX tick's arithmetic)."""
    def build(m, config):
        return m.ServiceSpec(
            registry=m.RegistrySpec(num_features=N),
            engine=m.EngineConfig(backend="device", margin=True,
                                  device=config(cell="3T1R")),
            mesh=m.MeshSpec(install=False),
            scheduler=m.SchedulerSpec(slots=16),
            cascade=m.CascadeSpec(tau=14.5, tau_units="count"))

    from repro_torch.serve import spec as tspec

    jsvc = JService.from_spec(build(jspec, ja.ACAMConfig))
    tsvc = TService.from_spec(build(tspec, ta.ACAMConfig), device="cpu")
    protos = []
    for i in range(3):
        bank, head, p = jsvc_lib.make_synthetic_tenant(
            20 + i, num_classes=6 + 2 * i, num_features=N)
        jsvc.register_tenant(f"t{i}", bank, head=head)
        tsvc.register_tenant(
            f"t{i}", convert.bank_from_numpy(*(to_np(a) for a in bank),
                                             device="cpu"),
            head=(np.array(head[0]), np.array(head[1])))
        protos.append(p)
    trace = []
    for i in range(40):
        f, _ = jsvc_lib.sample_tenant_queries(i, protos[i % 3], 1, noise=1.2)
        trace.append((f"t{i % 3}", f[0]))
    jr = jsvc.serve([jsvc_lib.ClassifyRequest(a, f) for a, f in trace])
    tr = tsvc.serve([tsvc_lib.ClassifyRequest(a, f) for a, f in trace])
    assert len(jr) == len(tr) == 40
    for a, b in zip(jr, tr):
        assert (a.request_id, a.tenant_id, a.pred, a.escalated, a.shed,
                a.energy_j, a.error) == (b.request_id, b.tenant_id, b.pred,
                                         b.escalated, b.shed, b.energy_j,
                                         b.error)
        assert np.float32(a.margin) == np.float32(b.margin)
    assert 0 < sum(r.escalated for r in tr) < 40
    assert jsvc.metrics()["classify_dispatches"] == \
        tsvc.metrics()["classify_dispatches"]


def _tie_case(n, d=8, rows=100):
    """Row r's query has n1 ones (n1 from d to N, at most ``rows`` values);
    its class window holds a template matching all n1 (ones) and one
    matching n1 - d: a margin of d counts, served against tau = d / N in
    matchline fractions."""
    n1s = np.arange(d, n + 1, -(-(n + 1 - d) // rows))
    m = len(n1s)
    tmpl = np.zeros((2 * m, 1, n), np.float32)
    q = np.zeros((m, n), np.float32)
    for r, n1 in enumerate(n1s):
        q[r, :n1] = 1.0
        tmpl[2 * r, 0] = 1.0
        tmpl[2 * r + 1, 0] = 1.0
        tmpl[2 * r + 1, 0, n1 - d:n1] = 0.0
    bank = dict(templates=tmpl, lower=tmpl, upper=tmpl,
                valid=np.ones((2 * m, 1), bool),
                thresholds=np.zeros((n,), np.float32))
    lo = (2 * np.arange(m)).astype(np.int32)
    return dict(bank=bank, feats=q, table=np.full((1, n), 0.5, np.float32),
                slot=np.zeros((m,), np.int32), lo=lo, hi=lo + 2,
                tau=np.full((m,), d / n, np.float32))


@pytest.mark.parametrize("cell,n", [("6T4R", 64), ("3T1R", 100),
                                    ("6T4R", 784), ("3T1R", 784)])
def test_served_margin_exactly_tau_matches_jitted_tick(cell, n):
    """Margins of exactly tau: the served tick gives the jitted JAX tick's
    margins and escalations bit for bit, including the rows where the
    op-by-op sense chain (the un-jitted engine) lands an ulp on the other
    side of tau."""
    x = _tie_case(n)
    jbank, tbank = _banks(x["bank"])
    jeng, teng = _engines(cell=cell)
    args = ("feats", "table", "slot")
    got = teng.classify_serve(*(t(x[a]) for a in args), tbank,
                              t(x["lo"]), t(x["hi"]), t(x["tau"]))
    want = jax.jit(jeng.classify_serve)(
        *(jnp.asarray(x[a]) for a in args), jbank, jnp.asarray(x["lo"]),
        jnp.asarray(x["hi"]), jnp.asarray(x["tau"]))
    _equal(got, want)
    margin, tau = np.asarray(want[2]), x["tau"]
    assert (margin == tau).any()  # exact ties are served
    eager = to_np(tmatch.engine_for(
        backend="device", device=ta.ACAMConfig(cell=cell)
    ).classify_features_margin(
        t(x["feats"] - 0.5), tbank, t(x["lo"]), t(x["hi"]))[2])
    assert ((eager < tau) != (margin < tau)).any()  # the op-by-op flip
