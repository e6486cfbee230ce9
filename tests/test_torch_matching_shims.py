"""The port's deprecated `repro_torch.core.matching` shims against the JAX
package's `repro.core.matching`: every shim on the reference, kernel and
device backends, both methods, and every lazily resolved re-export, fed the
same numpy inputs. Outputs are bit-identical (binary and dyadic operands).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import binary_bank, dyadic, t, to_np
from repro.core import matching as jm
from repro.core.templates import TemplateBank as JBank
from repro_torch.core import matching as tm
from repro_torch.core.templates import TemplateBank as TBank

ROOT = Path(__file__).resolve().parents[1]
N = 100
BACKENDS = ("reference", "kernel", "device")


def _case(seed, b=12, c=10, k=2):
    rng = np.random.default_rng(seed)
    bank = binary_bank(rng, c, k, N)
    lower = dyadic(rng, (c, k, N), -8, 1)
    bank.update(lower=lower, upper=lower + dyadic(rng, (c, k, N), 0, 9),
                thresholds=dyadic(rng, (N,), -2, 3))
    lo = rng.integers(0, c - 4, size=b).astype(np.int32)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c).astype(np.int32)
    fields = ("templates", "lower", "upper", "valid", "thresholds")
    return dict(
        jbank=JBank(*(jnp.asarray(bank[f]) for f in fields)),
        tbank=TBank(*(t(bank[f]) for f in fields)),
        queries=(rng.random((b, N)) > 0.5).astype(np.float32),
        feats=dyadic(rng, (b, N)), lo=lo, hi=hi,
        per_class=dyadic(rng, (b, c)))


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("backend", BACKENDS)
def test_score_shims(backend):
    x = _case(1)
    jb, tb = x["jbank"], x["tbank"]
    jq, tq = jnp.asarray(x["queries"]), t(x["queries"])
    _equal(tm.feature_count_scores(tq, tb.templates, tb.valid,
                                   backend=backend),
           jm.feature_count_scores(jq, jb.templates, jb.valid,
                                   backend=backend))
    # the JAX reference's raw similarity is held as XLA compiles it (under
    # jit): run op by op it rounds the Eq. 11 product on its own, which the
    # kernels never do; the device backend is held op by op, as the engine
    # runs it
    def jsim(*a):
        return jm.similarity_scores(*a, alpha=0.37, backend=backend)

    if backend == "reference":
        jsim = jax.jit(jsim)
    _equal(tm.similarity_scores(tq, tb.lower, tb.upper, tb.valid, alpha=0.37,
                                backend=backend),
           jsim(jq, jb.lower, jb.upper, jb.valid))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["feature_count", "similarity"])
def test_classify_shims(backend, method):
    x = _case(2)
    jb, tb = x["jbank"], x["tbank"]
    kw = dict(method=method, alpha=0.37, backend=backend)
    _equal(tm.classify(t(x["queries"]), tb, **kw),
           jm.classify(jnp.asarray(x["queries"]), jb, **kw))
    _equal(tm.classify_features(t(x["feats"]), tb, **kw),
           jm.classify_features(jnp.asarray(x["feats"]), jb, **kw))
    _equal(tm.classify_features_margin(t(x["feats"]), tb, t(x["lo"]),
                                       t(x["hi"]), **kw),
           jm.classify_features_margin(jnp.asarray(x["feats"]), jb,
                                       jnp.asarray(x["lo"]),
                                       jnp.asarray(x["hi"]), **kw))
    _equal(tm.classify_features_margin(t(x["feats"]), tb, **kw),
           jm.classify_features_margin(jnp.asarray(x["feats"]), jb, **kw))


def test_reexports():
    x = _case(3)
    assert tm.TINY_ELEMENTS == jm.TINY_ELEMENTS
    assert tm.MAX_FUSED_ROWS == jm.MAX_FUSED_ROWS
    assert tm.NEG == float(jm.NEG)
    assert tm.__all__ == jm.__all__
    pc = x["per_class"]
    pc[2] = pc[2, 0]  # a row of ties: the lowest index wins
    _equal(tm.classify_scores(t(pc)[:, :, None]),
           jm.classify_scores(jnp.asarray(pc)[:, :, None]))
    _equal(tm.winner_take_all(t(pc)), jm.winner_take_all(jnp.asarray(pc)))
    _equal(tm.window_margin(t(pc), t(x["lo"]), t(x["hi"]), cap=4.0),
           jm.window_margin(jnp.asarray(pc), jnp.asarray(x["lo"]),
                            jnp.asarray(x["hi"]), cap=4.0))
    jb, tb = x["jbank"], x["tbank"]
    _equal(tm.feature_count_scores_ref(t(x["queries"]), tb.templates,
                                       tb.valid),
           jm.feature_count_scores_ref(jnp.asarray(x["queries"]),
                                       jb.templates, jb.valid))
    q = x["queries"]
    _equal(tm.similarity_scores_ref(t(q), tb.lower, tb.upper, tb.valid),
           jm.similarity_scores_ref(jnp.asarray(q), jb.lower, jb.upper,
                                    jb.valid))
    with pytest.raises(AttributeError):
        tm.no_such_name  # noqa: B018


def test_set_and_get_backend():
    from repro_torch import match as tmatch

    before = tm.get_backend()
    assert before == jm.get_backend() == tmatch.default_backend()
    try:
        for name in ("device", "reference", "kernel", "auto"):
            tm.set_backend(name)
            jm.set_backend(name)
            assert tm.get_backend() == jm.get_backend() == name
            assert tmatch.engine_for().config.backend == name
        with pytest.raises(ValueError, match="unknown matching backend"):
            tm.set_backend("analog")
        with tm.use_backend("device"):
            assert tm.get_backend() == "device"
        assert tm.get_backend() == "auto"
    finally:
        tm.set_backend(before)
        jm.set_backend(before)


def test_shims_import_before_the_engine():
    """Imported first, in a process without jax or repro, the shim module
    imports without a cycle and resolves its re-exports on first use."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.core import matching
assert "TINY_ELEMENTS" not in vars(matching)
assert matching.TINY_ELEMENTS == 32768
assert "TINY_ELEMENTS" in vars(matching)
assert matching.get_backend() in ("auto", "reference", "kernel", "device")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_MATCHING_BACKEND", None)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
