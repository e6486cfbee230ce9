"""The port's `MatchEngine` against the JAX package's, entry point by entry
point: `classify`, `classify_features`, `classify_features_margin` and
`classify_serve`, on the reference and kernel backends and under
``serve_fusion="compose"``. Feature counts are integers, so every output is
bit-identical. Operands are dyadic (exact in any summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_equal_outputs, binary_bank, dyadic, t
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


def test_similarity_reference_and_kernel_refusal():
    x = _inputs(7, 8, *RESIDENT)
    jbank, tbank = _banks(x["bank"])
    jeng, teng = _engines("reference", method="similarity")
    jp, jpc = jeng.classify_features(jnp.asarray(x["feats"]), jbank)
    tp, tpc = teng.classify_features(t(x["feats"]), tbank)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tpc.numpy(), np.asarray(jpc), rtol=1e-5,
                               atol=1e-6)
    kernel = tmatch.engine_from_config(tmatch.EngineConfig(
        method="similarity", backend="kernel"))
    with pytest.raises(NotImplementedError, match="later slice"):
        kernel.classify_features(t(x["feats"]), tbank)


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
    with pytest.raises(ValueError, match="unknown matching backend"):
        tmatch.engine_for(backend="device")
    assert tmatch.MAX_FUSED_ROWS == jmatch.MAX_FUSED_ROWS
    assert tmatch.TINY_ELEMENTS == jmatch.TINY_ELEMENTS
    assert tmatch.EngineConfig._fields == jmatch.EngineConfig._fields
