"""The port's front end and hybrid classifier against the JAX package's.

Student features and logits: the JAX params carried across with
`repro_torch.convert` give the same values within rtol 1e-4, atol 1e-5 (f32
convolutions sum in a different order). Fed the same features, the ACAM
head and `HybridClassifier.predict` are bit-identical. Template generation
on dyadic features gives the same bank, at k = 1 and 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import dyadic, t, to_np
from repro.core import hybrid as jhybrid
from repro.core import quant as jquant
from repro.core import templates as jtemplates
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import hybrid as thybrid
from repro_torch.core import quant as tquant
from repro_torch.core import templates as ttemplates
from repro_torch.models import cnn as tcnn

SMALL = dict(filters=(4, 8, 8, 2))  # 98 features


def _jax_student(seed):
    """JAX student params with non-trivial BN statistics, as numpy."""
    params = jcnn.init_student(jax.random.PRNGKey(seed),
                               jcnn.StudentConfig(**SMALL))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for bn in ("bn1", "bn2"):
        c = params[bn]["scale"].shape[0]
        params[bn] = dict(
            scale=(1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
            bias=(0.1 * rng.standard_normal(c)).astype(np.float32),
            mean=(0.3 * rng.standard_normal(c)).astype(np.float32),
            var=(0.5 + rng.random(c)).astype(np.float32))
    for name in ("conv1", "conv2", "conv3", "conv4", "head"):
        params[name]["b"] = (0.05 * rng.standard_normal(
            params[name]["b"].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("quantize", [False, True])
def test_student_features_and_logits(quantize):
    params = _jax_student(0)
    model = convert.student_from_numpy(params, device="cpu")
    assert model.cfg == tcnn.StudentConfig(**SMALL)
    x = np.random.default_rng(1).standard_normal((6, 32, 32, 1)
                                                 ).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want_f = np.asarray(jcnn.student_features(jp, jnp.asarray(x),
                                              quantize=quantize)[0])
    want_l = np.asarray(jcnn.student_logits(jp, jnp.asarray(x),
                                            quantize=quantize)[0])
    got_f = tcnn.student_features(model, x, quantize=quantize).numpy()
    got_l = tcnn.student_logits(model, x, quantize=quantize).numpy()
    assert got_f.shape == (6, 98) and (got_f > 0).any()
    np.testing.assert_allclose(got_f, want_f, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-5)


def test_init_student_and_macs():
    import torch

    cfg = tcnn.StudentConfig()
    model = tcnn.init_student(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    assert not model.training
    assert model.conv2.weight.shape == (128, 32, 3, 3)
    std = float(model.conv3.weight.detach().std())
    assert abs(std - np.sqrt(2.0 / (9 * 128))) < 0.01
    assert tcnn.student_macs(cfg) == jcnn.student_macs(jcnn.StudentConfig())
    assert cfg.num_features == 784


def test_fake_quant_and_binarize_bit_identical():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tquant.fake_quant_int8(t(w)).numpy(),
        np.asarray(jquant.fake_quant_int8(jnp.asarray(w))))
    q, s = tquant.quantize_int8(t(w))
    jq, js = jquant.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    f, thr = rng.standard_normal((5, 7)), rng.standard_normal(7)
    np.testing.assert_array_equal(
        tquant.binarize(t(f.astype(np.float32)), t(thr.astype(np.float32))
                        ).numpy(),
        np.asarray(jquant.binarize(jnp.asarray(f, jnp.float32),
                                   jnp.asarray(thr, jnp.float32))))


def test_fake_quant_tree_and_thresholds():
    """fake_quant_tree quantises every ndim >= 2 leaf of a nested dict and
    leaves the rest; mean and median thresholds match the JAX package."""
    params = _jax_student(1)
    want = jquant.fake_quant_tree(jax.tree_util.tree_map(jnp.asarray, params))
    got = tquant.fake_quant_tree(jax.tree_util.tree_map(t, params))
    for layer, leaves in want.items():
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(got[layer][name].numpy(),
                                          np.asarray(leaf),
                                          err_msg=f"{layer}.{name}")
    feats = dyadic(np.random.default_rng(8), (7, 12), -8, 9)
    for method in ("mean", "median"):
        np.testing.assert_allclose(
            tquant.feature_thresholds(t(feats), method).numpy(),
            np.asarray(jquant.feature_thresholds(jnp.asarray(feats), method)),
            rtol=1e-6)
    with pytest.raises(ValueError, match="unknown threshold method"):
        tquant.feature_thresholds(t(feats), "mode")


def test_generate_templates_dyadic():
    rng = np.random.default_rng(4)
    feats = dyadic(rng, (90, 48), 0, 13)
    labels = rng.integers(0, 9, size=90).astype(np.int32)
    labels[labels == 8] = 7  # class 8 has no samples: stays invalid
    want = jtemplates.generate_templates(jnp.asarray(feats),
                                         jnp.asarray(labels), 9)
    got = ttemplates.generate_templates(t(feats), t(labels), 9)
    for name in ("templates", "lower", "upper", "valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.thresholds.numpy(),
                               np.asarray(want.thresholds), rtol=1e-6)
    assert not bool(got.valid[8, 0])
    # k = 2: k-means per class, the same bank bit for bit
    want = jtemplates.generate_templates(jnp.asarray(feats),
                                         jnp.asarray(labels), 9, k=2)
    got = ttemplates.generate_templates(t(feats), t(labels), 9, k=2)
    for name in ("templates", "lower", "upper", "valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"k=2 {name}")
    assert got.templates.shape == (9, 2, 48) and not bool(got.valid[8].any())


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_head_and_predict_on_same_features(backend):
    rng = np.random.default_rng(5)
    cal = rng.standard_normal((120, 98)).astype(np.float32)
    labels = rng.integers(0, 10, size=120).astype(np.int32)
    jbank = jtemplates.generate_templates(jnp.asarray(cal),
                                          jnp.asarray(labels), 10)
    tbank = convert.bank_from_numpy(*(np.asarray(a) for a in jbank),
                                    device="cpu")
    jhead = jhybrid.ACAMHead(bank=jbank, backend=backend)
    thead = thybrid.ACAMHead(bank=tbank, backend=backend)
    feats = rng.standard_normal((40, 98)).astype(np.float32)
    jp, jpc = jhead(jnp.asarray(feats))
    tp, tpc = thead(t(feats))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))
    assert thead.energy_per_inference() == jhead.energy_per_inference()

    def identity(p, x):
        return x

    jclf = jhybrid.HybridClassifier(None, identity, jhead)
    tclf = thybrid.HybridClassifier(None, identity, thead, device="cpu")
    np.testing.assert_array_equal(tclf.predict(feats).numpy(),
                                  np.asarray(jclf.predict(jnp.asarray(feats))))
    y = np.array(jclf.predict(jnp.asarray(feats)))
    y[::3] = (y[::3] + 1) % 10
    assert tclf.accuracy(feats, y, batch_size=16) == \
        jclf.accuracy(jnp.asarray(feats), jnp.asarray(y), batch_size=16)


def test_fit_acam_head_through_the_student():
    """fit_acam_head end to end through converted weights: thresholds agree
    to float tolerance, template bits agree wherever the class mean is not
    within float noise of its threshold, and predict is the head applied to
    the student's features."""
    params = _jax_student(3)
    model = convert.student_from_numpy(params, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 32, 32, 1)).astype(np.float32)
    y = np.repeat(np.arange(4), 10).astype(np.int32)

    def jfeat(p, a):
        return jcnn.student_features(p, a)[0]

    jhead = jhybrid.fit_acam_head(jfeat, jp, jnp.asarray(x), jnp.asarray(y),
                                  4, batch_size=16)
    thead = thybrid.fit_acam_head(tcnn.student_features, model, x, y, 4,
                                  batch_size=16, device="cpu")
    jthr = np.asarray(jhead.bank.thresholds)
    np.testing.assert_allclose(thead.bank.thresholds.numpy(), jthr,
                               rtol=1e-4, atol=1e-5)
    feats = tcnn.student_features(model, x).numpy()
    means = np.stack([feats[y == c].mean(0) for c in range(4)])
    clear = np.abs(means - jthr[None]) > 1e-3
    assert clear.mean() > 0.25
    np.testing.assert_array_equal(
        thead.bank.templates.numpy()[:, 0][clear],
        np.asarray(jhead.bank.templates)[:, 0][clear])
    clf = thybrid.HybridClassifier(model, tcnn.student_features, thead,
                                   device="cpu")
    np.testing.assert_array_equal(clf.predict(x).numpy(),
                                  thead(t(feats))[0].numpy())


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("method", ["feature_count", "similarity"])
def test_head_scores_and_similarity_predict(backend, method):
    """`ACAMHead.scores` for both methods, and the similarity head's
    classify and `predict`, fed the same features: bit-identical (binary
    windows from `generate_templates`, alpha 0.37)."""
    rng = np.random.default_rng(7)
    cal = dyadic(rng, (150, 100), -8, 9)
    labels = rng.integers(0, 10, size=150).astype(np.int32)
    jbank = jtemplates.generate_templates(jnp.asarray(cal),
                                          jnp.asarray(labels), 10)
    tbank = convert.bank_from_numpy(*(np.asarray(a) for a in jbank),
                                    device="cpu")
    jhead = jhybrid.ACAMHead(bank=jbank, method=method, alpha=0.37,
                             backend=backend)
    thead = thybrid.ACAMHead(bank=tbank, method=method, alpha=0.37,
                             backend=backend)
    feats = dyadic(rng, (30, 100), -8, 9)
    np.testing.assert_array_equal(thead.scores(t(feats)).numpy(),
                                  np.asarray(jhead.scores(jnp.asarray(feats))))
    jp, jpc = jhead(jnp.asarray(feats))
    tp, tpc = thead(t(feats))
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    def identity(p, x):
        return x

    jclf = jhybrid.HybridClassifier(None, identity, jhead)
    tclf = thybrid.HybridClassifier(None, identity, thead, device="cpu")
    np.testing.assert_array_equal(tclf.predict(feats).numpy(),
                                  np.asarray(jclf.predict(jnp.asarray(feats))))
    # the bank programmed into an ideal ACAM array: the same windows and
    # the same calibrated matchline current
    jprog, tprog = jhead.to_acam(), thead.to_acam(device="cpu")
    for name in ("lower", "upper", "valid"):
        np.testing.assert_array_equal(getattr(tprog, name).numpy(),
                                      np.asarray(getattr(jprog, name)))
    assert tuple(tprog.config) == tuple(jprog.config)
