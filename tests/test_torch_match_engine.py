"""The port's `MatchEngine` against the JAX package's, entry point by entry
point: `classify`, `classify_features`, `classify_features_margin`,
`classify_serve`, the raw `scores` / `feature_count_scores` /
`similarity_scores` and `__call__`, on the reference and kernel backends and
under ``serve_fusion="compose"``, for both matching methods. Feature counts
are integers; similarity scores follow the JAX kernels' arithmetic (hit
count, ``* float32(1/N)``, ``/ fma(alpha, D, 1)``) and are tested at N =
100, where 1/N is inexact. Every output is bit-identical. Operands are
binary or dyadic (exact in any summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_equal_outputs, binary_bank, binary_windows,
                           dyadic, dyadic_windows, t)
from repro import match as jmatch
from repro.core.templates import TemplateBank as JBank
from repro_torch import match as tmatch
from repro_torch.core.templates import TemplateBank as TBank

N = 64
SLOTS = 8
RESIDENT, CHUNKED = (12, 4), (1100, 2)


def _inputs(seed, b, c, k):
    rng = np.random.default_rng(seed)
    bank = binary_bank(rng, c, k, N)
    lo_w = dyadic(rng, (c, k, N), -8, 1)
    bank.update(lower=lo_w, upper=lo_w + dyadic(rng, (c, k, N), 0, 9),
                thresholds=dyadic(rng, (N,), -2, 3))
    lo = rng.integers(0, max(c - 4, 1), size=b).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c).astype(np.int32)
    hi[0] = lo[0]  # empty window
    return dict(
        bank=bank, feats=dyadic(rng, (b, N)),
        queries=(rng.random((b, N)) > 0.5).astype(np.float32),
        table=dyadic(rng, (SLOTS, N), -4, 5),
        slot=rng.integers(0, SLOTS, size=b).astype(np.int32), lo=lo, hi=hi)


def _banks(bank):
    fields = ("templates", "lower", "upper", "valid", "thresholds")
    return (JBank(*(jnp.asarray(bank[f]) for f in fields)),
            TBank(*(t(bank[f]) for f in fields)))


def _engines(backend, method="feature_count", serve_fusion="mega"):
    return (jmatch.engine_from_config(jmatch.EngineConfig(
                method=method, backend=backend, serve_fusion=serve_fusion)),
            tmatch.engine_from_config(tmatch.EngineConfig(
                method=method, backend=backend, serve_fusion=serve_fusion)))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_entry_points_bit_identical(backend, c, k):
    x = _inputs(c + k, 12, c, k)
    jbank, tbank = _banks(x["bank"])
    jeng, teng = _engines(backend)
    assert_equal_outputs(teng.classify(t(x["queries"]), tbank),
                         jeng.classify(jnp.asarray(x["queries"]), jbank))
    assert_equal_outputs(teng.classify_features(t(x["feats"]), tbank),
                         jeng.classify_features(jnp.asarray(x["feats"]),
                                                jbank))
    assert_equal_outputs(
        teng.classify_features_margin(t(x["feats"]), tbank, t(x["lo"]),
                                      t(x["hi"])),
        jeng.classify_features_margin(jnp.asarray(x["feats"]), jbank,
                                      jnp.asarray(x["lo"]),
                                      jnp.asarray(x["hi"])))


@pytest.mark.parametrize("backend,fusion", [("reference", "mega"),
                                            ("kernel", "mega"),
                                            ("kernel", "compose")])
@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_classify_serve_bit_identical(backend, fusion, c, k):
    x = _inputs(3 * c + k, 16, c, k)
    jbank, tbank = _banks(x["bank"])
    ref = jmatch.engine_from_config(jmatch.EngineConfig(backend="reference"))
    margins = np.asarray(ref.classify_serve(
        jnp.asarray(x["feats"]), jnp.asarray(x["table"]),
        jnp.asarray(x["slot"]), jbank, jnp.asarray(x["lo"]),
        jnp.asarray(x["hi"]))[2])
    tau = (margins + np.where(np.arange(16) % 2 == 0, 0.5, -0.5)
           ).astype(np.float32)
    jeng, teng = _engines(backend, serve_fusion=fusion)
    want = jeng.classify_serve(
        jnp.asarray(x["feats"]), jnp.asarray(x["table"]),
        jnp.asarray(x["slot"]), jbank, jnp.asarray(x["lo"]),
        jnp.asarray(x["hi"]), jnp.asarray(tau))
    got = teng.classify_serve(t(x["feats"]), t(x["table"]), t(x["slot"]),
                              tbank, t(x["lo"]), t(x["hi"]), t(tau))
    assert_equal_outputs(got, want)
    esc = got[3].numpy()
    assert esc.any() and not esc.all()
    # defaults: whole-bank windows, tau -inf (never escalate)
    got = teng.classify_serve(t(x["feats"]), t(x["table"]), t(x["slot"]),
                              tbank)
    assert_equal_outputs(got, jeng.classify_serve(
        jnp.asarray(x["feats"]), jnp.asarray(x["table"]),
        jnp.asarray(x["slot"]), jbank))
    assert not got[3].any()


NS = 100  # the similarity tests' feature count: 1/N is inexact
ALPHAS = (1.0, 0.37)


def _sim_inputs(seed, b, c, k, kind):
    """`_inputs` at N = 100 with binary or dyadic windows."""
    rng = np.random.default_rng(seed)
    bank = binary_bank(rng, c, k, NS)
    lower, upper = (binary_windows if kind == "binary"
                    else dyadic_windows)(rng, c, k, NS)
    bank.update(lower=lower, upper=upper,
                thresholds=dyadic(rng, (NS,), -2, 3))
    lo = rng.integers(0, max(c - 4, 1), size=b).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c).astype(np.int32)
    hi[0] = lo[0]  # empty window
    return dict(
        bank=bank, feats=dyadic(rng, (b, NS)),
        queries=(rng.random((b, NS)) > 0.5).astype(np.float32),
        table=dyadic(rng, (SLOTS, NS), -4, 5),
        slot=rng.integers(0, SLOTS, size=b).astype(np.int32), lo=lo, hi=hi)


def _sim_engines(backend, alpha, serve_fusion="mega", margin=False):
    cfg = dict(method="similarity", alpha=alpha, backend=backend,
               serve_fusion=serve_fusion, margin=margin)
    return (jmatch.engine_from_config(jmatch.EngineConfig(**cfg)),
            tmatch.engine_from_config(tmatch.EngineConfig(**cfg)))


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("kind", ["binary", "dyadic"])
def test_similarity_reference_bit_identical(kind, alpha):
    """The reference backend's similarity per_class equals the JAX
    package's bit for bit at N = 100 (Eq. 10 as ``count * float32(1/N)``,
    Eq. 11's denominator as one fused multiply-add, as XLA compiles it)."""
    x = _sim_inputs(17, 12, *RESIDENT, kind)
    jbank, tbank = _banks(x["bank"])
    jeng, teng = _sim_engines("reference", alpha)
    jp, jpc = jeng.classify_features(jnp.asarray(x["feats"]), jbank)
    tp, tpc = teng.classify_features(t(x["feats"]), tbank)
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_similarity_entry_points_bit_identical(backend, c, k):
    for kind, alpha in (("binary", 1.0), ("dyadic", 0.37)):
        x = _sim_inputs(c + k + 5, 12, c, k, kind)
        jbank, tbank = _banks(x["bank"])
        jeng, teng = _sim_engines(backend, alpha)
        assert_equal_outputs(
            teng.classify(t(x["queries"]), tbank),
            jeng.classify(jnp.asarray(x["queries"]), jbank))
        assert_equal_outputs(
            teng.classify_features(t(x["feats"]), tbank),
            jeng.classify_features(jnp.asarray(x["feats"]), jbank))
        assert_equal_outputs(
            teng.classify_features_margin(t(x["feats"]), tbank, t(x["lo"]),
                                          t(x["hi"])),
            jeng.classify_features_margin(jnp.asarray(x["feats"]), jbank,
                                          jnp.asarray(x["lo"]),
                                          jnp.asarray(x["hi"])))


@pytest.mark.parametrize("backend,fusion", [("reference", "mega"),
                                            ("kernel", "mega"),
                                            ("kernel", "compose")])
@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_similarity_classify_serve_bit_identical(backend, fusion, c, k):
    x = _sim_inputs(3 * c + k, 16, c, k, "dyadic")
    jbank, tbank = _banks(x["bank"])
    args = [x[f] for f in ("feats", "table", "slot")]
    ref, _ = _sim_engines("reference", 0.37)
    margins = np.asarray(ref.classify_serve(
        *(jnp.asarray(a) for a in args), jbank, jnp.asarray(x["lo"]),
        jnp.asarray(x["hi"]))[2])
    tau = (margins + np.where(np.arange(16) % 2 == 0, 1e-3, -1e-3)
           ).astype(np.float32)
    jeng, teng = _sim_engines(backend, 0.37, serve_fusion=fusion)
    want = jeng.classify_serve(*(jnp.asarray(a) for a in args), jbank,
                               jnp.asarray(x["lo"]), jnp.asarray(x["hi"]),
                               jnp.asarray(tau))
    got = teng.classify_serve(*(t(a) for a in args), tbank, t(x["lo"]),
                              t(x["hi"]), t(tau))
    assert_equal_outputs(got, want)
    esc = got[3].numpy()
    assert esc.any() and not esc.all()
    got = teng.classify_serve(*(t(a) for a in args), tbank)
    assert_equal_outputs(got, jeng.classify_serve(
        *(jnp.asarray(a) for a in args), jbank))
    assert not got[3].any()


@pytest.mark.parametrize("backend", ["reference", "kernel"])
@pytest.mark.parametrize("method", ["feature_count", "similarity"])
def test_score_entry_points_and_call(backend, method):
    """`scores`, `feature_count_scores`, `similarity_scores` and `__call__`
    (with and without margins). The JAX reference backend's raw similarity
    scores are held as XLA compiles them (under jit): run op by op, JAX
    rounds the Eq. 11 product on its own, which the kernels never do."""
    x = _sim_inputs(23, 10, *RESIDENT, "dyadic")
    jbank, tbank = _banks(x["bank"])
    cfg = dict(method=method, alpha=0.37, backend=backend)
    jeng = jmatch.engine_from_config(jmatch.EngineConfig(**cfg))
    teng = tmatch.engine_from_config(tmatch.EngineConfig(**cfg))
    q, jq = t(x["queries"]), jnp.asarray(x["queries"])
    b = x["bank"]
    compiled = jax.jit(lambda fn, *a: fn(*a), static_argnums=0)
    np.testing.assert_array_equal(teng.scores(q, tbank).numpy(),
                                  np.asarray(compiled(jeng.scores, jq, jbank)))
    np.testing.assert_array_equal(
        teng.feature_count_scores(q, t(b["templates"]), t(b["valid"])
                                  ).numpy(),
        np.asarray(jeng.feature_count_scores(
            jq, jnp.asarray(b["templates"]), jnp.asarray(b["valid"]))))
    np.testing.assert_array_equal(
        teng.similarity_scores(t(x["feats"]), t(b["lower"]), t(b["upper"]),
                               t(b["valid"])).numpy(),
        np.asarray(compiled(jeng.similarity_scores,
                            jnp.asarray(x["feats"]),
                            jnp.asarray(b["lower"]), jnp.asarray(b["upper"]),
                            jnp.asarray(b["valid"]))))
    assert_equal_outputs(teng(t(x["feats"]), tbank),
                         jeng(jnp.asarray(x["feats"]), jbank))
    margin_cfg = dict(cfg, margin=True)
    jm = jmatch.engine_from_config(jmatch.EngineConfig(**margin_cfg))
    tm = tmatch.engine_from_config(tmatch.EngineConfig(**margin_cfg))
    assert_equal_outputs(
        tm(t(x["feats"]), tbank, t(x["lo"]), t(x["hi"])),
        jm(jnp.asarray(x["feats"]), jbank, jnp.asarray(x["lo"]),
           jnp.asarray(x["hi"])))


def test_auto_backend_and_defaults():
    x = _inputs(11, 4, *RESIDENT)
    _, tbank = _banks(x["bank"])
    eng = tmatch.engine_from_config(tmatch.EngineConfig(backend="auto"))
    # tiny CPU shape: the JAX package's rule picks the reference backend
    assert eng.backend(t(x["feats"]), tbank).name == "reference"
    big = torch.zeros((1024, N))
    assert eng.backend(big, tbank).name == "kernel"
    with tmatch.use_backend("reference"):
        assert tmatch.engine_for().config.backend == "reference"
    assert tmatch.default_backend() == jmatch.default_backend()
    assert tmatch.backend_names() == jmatch.backend_names()
    assert tmatch.engine_for(backend="device").config.backend == \
        jmatch.engine_for(backend="device").config.backend == "device"
    assert tmatch.MAX_FUSED_ROWS == jmatch.MAX_FUSED_ROWS
    assert tmatch.TINY_ELEMENTS == jmatch.TINY_ELEMENTS
    assert tmatch.EngineConfig._fields == jmatch.EngineConfig._fields
