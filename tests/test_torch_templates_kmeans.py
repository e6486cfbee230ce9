"""k-means, the silhouette score and multi-template banks (paper §II-D-1):
the port's `core/templates.py` against the JAX package's on the same numpy
inputs.

Tolerances: assignments and bank bits equal; centroids within rtol 1e-5,
atol 1e-6 on float features (the centroid sums ``one_hot.T @ x`` and the
means add in another order in each framework) and bit-identical on
small-integer features (every sum exact); silhouette scores within 1e-5
(absolute; a mean of square roots of sums in another order); thresholds
and real (not binarised) windows within rtol 1e-6 (a mean and a std over
samples).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import dyadic, t, to_np
from repro.core import hybrid as jhybrid
from repro.core import templates as jtemplates
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import hybrid as thybrid
from repro_torch.core import templates as ttemplates
from repro_torch.models import cnn as tcnn

BANK = ("templates", "lower", "upper", "valid")


def _points(kind: str, n: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(0, 5, (n, d)).astype(np.float32)
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("n,d,k", [(60, 16, 3), (200, 98, 2), (37, 784, 3)])
def test_kmeans_matches_jax(n, d, k, kind):
    x = _points(kind, n, d, n + d + k)
    jc, ja = jtemplates.kmeans(jnp.asarray(x), k)
    tc, ta = ttemplates.kmeans(t(x), k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if kind == "int":
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    else:
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-6)
    assert tc.shape == (k, d) and ta.dtype == torch.int64


def test_kmeans_keeps_an_empty_clusters_centroid():
    """Three copies of one point and one other, k = 3: the init picks the
    copy again for the third centroid, ties go to the lowest index, so the
    third cluster stays empty and keeps its centroid, in both packages."""
    x = np.zeros((4, 6), np.float32)
    x[3] = 2.0
    jc, ja = jtemplates.kmeans(jnp.asarray(x), 3)
    tc, ta = ttemplates.kmeans(t(x), 3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert ta.tolist() == [0, 0, 0, 1]


@pytest.mark.parametrize("k", [2, 3])
def test_silhouette_score_matches_jax_with_a_singleton(k):
    rng = np.random.default_rng(11 + k)
    x = rng.standard_normal((30, 20)).astype(np.float32)
    assign = rng.integers(0, k, 30).astype(np.int32)
    assign[0] = k - 1
    assign[assign == k - 1] = 0
    assign[0] = k - 1  # cluster k - 1 holds one point: s = 0 there
    want = float(jtemplates.silhouette_score(jnp.asarray(x),
                                             jnp.asarray(assign), k))
    got = float(ttemplates.silhouette_score(t(x), t(assign).long(), k))
    assert abs(got - want) <= 1e-5
    # and on k-means' own assignment
    _, ja = jtemplates.kmeans(jnp.asarray(x), k)
    want = float(jtemplates.silhouette_score(jnp.asarray(x), ja, k))
    got = float(ttemplates.silhouette_score(
        t(x), ttemplates.kmeans(t(x), k)[1], k))
    assert abs(got - want) <= 1e-5


@pytest.mark.parametrize("k,binary_windows", [(2, True), (3, True),
                                               (2, False)])
def test_generate_templates_matches_jax(k, binary_windows):
    """Class 5 has no sample (invalid), class 4 fewer than k (one template
    from its mean), class 3 three copies of one point and one other (a
    cluster left empty at k = 3); dyadic features keep every mean the same
    in both packages, so the binary bank is equal bit for bit. Real
    windows (mean +/- std) hold within rtol 1e-6, atol 1e-6: the std sums
    in another order."""
    rng = np.random.default_rng(20 + k)
    feats = dyadic(rng, (120, 40), 0, 13)
    labels = rng.integers(0, 2, 120).astype(np.int32)
    labels[:4] = 3  # class 2 has no sample either
    feats[:3] = feats[0]
    labels[4] = 4  # one sample: fewer than k
    want = jtemplates.generate_templates(jnp.asarray(feats),
                                         jnp.asarray(labels), 6, k=k,
                                         binary_windows=binary_windows)
    got = ttemplates.generate_templates(t(feats), t(labels), 6, k=k,
                                        binary_windows=binary_windows)
    for name in BANK if binary_windows else ("templates", "valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in () if binary_windows else ("lower", "upper"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.thresholds.numpy(),
                               np.asarray(want.thresholds), rtol=1e-6)
    valid = got.valid.numpy()
    assert not valid[[2, 5]].any()
    assert valid[4].tolist() == [True] + [False] * (k - 1)
    assert valid[3].tolist() == ([True, True] if k == 2
                                 else [True, True, False])


def test_select_k_by_silhouette_matches_jax():
    """Two well separated blobs per class: k = 2 wins in both packages,
    every score within 1e-5; a class of at most k samples is skipped."""
    rng = np.random.default_rng(30)
    centres = rng.standard_normal((3, 2, 24)).astype(np.float32) * 4
    labels = np.repeat(np.arange(3), 40).astype(np.int32)
    side = np.tile(np.repeat([0, 1], 20), 3)
    feats = (centres[labels, side]
             + 0.3 * rng.standard_normal((120, 24))).astype(np.float32)
    feats = np.concatenate([feats, np.zeros((2, 24), np.float32)])
    labels = np.concatenate([labels, [3, 3]]).astype(np.int32)
    jbest, jscores = jtemplates.select_k_by_silhouette(
        jnp.asarray(feats), jnp.asarray(labels), 4)
    tbest, tscores = ttemplates.select_k_by_silhouette(t(feats), t(labels),
                                                       4)
    assert tbest == jbest == 2
    assert tscores.keys() == jscores.keys()
    for k, v in jscores.items():
        assert abs(tscores[k] - v) <= 1e-5, k


def _exact_student(seed: int) -> dict:
    """JAX student params (98 features) whose features are exact in f32:
    weights of quarter steps, zero biases, identity BatchNorm (var + eps
    rounds to 1), so both packages compute the same bits."""
    cfg = jcnn.StudentConfig(filters=(4, 8, 8, 2))
    params = jax.tree_util.tree_map(
        np.asarray, jcnn.init_student(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("conv1", "conv2", "conv3", "conv4", "head"):
        params[name]["w"] = dyadic(rng, params[name]["w"].shape, -1, 2)
        params[name]["b"] = np.zeros_like(params[name]["b"])
    var = np.float32(1) - np.float32(1e-5)
    assert np.float32(var + np.float32(1e-5)) == 1.0
    for bn in ("bn1", "bn2"):
        c = params[bn]["scale"].shape[0]
        params[bn] = dict(scale=np.ones(c, np.float32),
                          bias=np.zeros(c, np.float32),
                          mean=np.zeros(c, np.float32),
                          var=np.full(c, var, np.float32))
    return params


def test_fit_acam_head_k2_predicts_as_jax():
    """`fit_acam_head(k=2)` and `HybridClassifier.predict` through a
    student carried across by `convert`: the same features, the same
    K = 2 bank and the same predictions."""
    params = _exact_student(4)
    model = convert.student_from_numpy(params, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.default_rng(9)
    x = dyadic(rng, (48, 32, 32, 1), -4, 5)
    y = np.repeat(np.arange(3), 16).astype(np.int32)

    def jfeat(p, v):
        return jcnn.student_features(p, v)[0]

    def tfeat(p, v):
        return tcnn.student_features(p, v)

    np.testing.assert_array_equal(tfeat(model, x).numpy(),
                                  np.asarray(jfeat(jp, jnp.asarray(x))))
    jhead = jhybrid.fit_acam_head(jfeat, jp, jnp.asarray(x), jnp.asarray(y),
                                  3, k=2)
    thead = thybrid.fit_acam_head(tfeat, model, x, y, 3, k=2,
                                  device="cpu")
    for name in BANK:
        np.testing.assert_array_equal(to_np(getattr(thead.bank, name)),
                                      np.asarray(getattr(jhead.bank, name)),
                                      err_msg=name)
    assert thead.bank.k == 2
    xq = dyadic(np.random.default_rng(10), (20, 32, 32, 1), -4, 5)
    want = jhybrid.HybridClassifier(jp, jfeat, jhead).predict(jnp.asarray(xq))
    got = thybrid.HybridClassifier(model, tfeat, thead,
                                   device="cpu").predict(xq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
