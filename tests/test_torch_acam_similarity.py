"""The port's acam_similarity kernels (B5, B6, B7b) against the JAX package's.

The same numpy inputs go through `repro.kernels.acam_similarity.ops` (Pallas
in interpret mode on the CPU) and `repro_torch.kernels.acam_similarity.ops`
(the plain PyTorch versions on the CPU), at N = 100 (not a power of two, so
1/N is inexact) and alpha in {1.0, 0.37}. On binary and dyadic windows
every output is bit-identical: the port computes Eq. 9-11 in the order XLA
compiles the JAX kernels (hit count, ``* float32(1/N)``, ``/ fma(alpha, D,
1)``). Non-dyadic windows agree within rtol 1e-5, atol 1e-6 (the ROADMAP
tolerance; D sums in another order).
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_equal_outputs, binary_windows, dyadic,
                           dyadic_windows, pack_words, packed_hits, t,
                           window_planes)
from repro.kernels.acam_similarity import ops as jops
from repro.kernels.acam_similarity.acam_similarity import (
    acam_similarity as jsim)
from repro.kernels.acam_similarity.ref import acam_similarity_ref as jref
from repro_torch.kernels import layout
from repro_torch.kernels.acam_similarity import acam_similarity as asim
from repro_torch.kernels.acam_similarity import ops as tops
from repro_torch.kernels.acam_match import acam_match as am
from repro_torch.kernels.acam_similarity.ref import (acam_similarity_ref,
                                                     eq11, fma_one,
                                                     hits_and_distance)

N = 100
MAX_ROWS = 2048
T_ROWS = 8
RESIDENT, CHUNKED = (12, 4), (1100, 2)
ALPHAS = (1.0, 0.37)


def _case(seed, b, c, k, n, kind):
    """Features, thresholds, (C, K, N) windows of ``kind`` ("binary",
    "dyadic" or "real"), ~80% valid rows, windows per row (row 0 empty),
    slots, a thresholds table, and raw queries for B7b."""
    rng = np.random.default_rng(seed)
    if kind == "binary":
        lower, upper = binary_windows(rng, c, k, n)
    elif kind == "dyadic":
        lower, upper = dyadic_windows(rng, c, k, n)
    else:
        lower = rng.standard_normal((c, k, n), dtype=np.float32) * 0.5
        upper = lower + np.abs(rng.standard_normal((c, k, n),
                                                   dtype=np.float32))
    lo = rng.integers(0, max(c - 4, 1), size=b)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c)
    hi[0] = lo[0]
    q = (rng.standard_normal((b, n), dtype=np.float32) if kind == "real"
         else dyadic(rng, (b, n)))
    return dict(lower=lower, upper=upper, valid=rng.random((c, k)) < 0.8,
                f=dyadic(rng, (b, n)), thr=dyadic(rng, (n,), -2, 3),
                lo=lo.astype(np.int32), hi=hi.astype(np.int32),
                table=dyadic(rng, (T_ROWS, n), -4, 5),
                slot=rng.integers(0, T_ROWS, size=b).astype(np.int32), q=q)


def _with_taus(x, alpha, max_rows=MAX_ROWS):
    """Taus straddling every served margin; -inf on row 0, as the
    scheduler pads."""
    margins = np.asarray(jops.serve_classify(
        *(jnp.asarray(x[f]) for f in ("f", "table", "slot", "lower", "upper",
                                      "valid", "lo", "hi")),
        alpha=alpha, max_rows=max_rows)[2])
    sign = np.where(np.arange(len(margins)) % 2 == 0, 1e-3, -1e-3)
    tau = (margins + sign).astype(np.float32)
    tau[0] = -np.inf
    return dict(x, tau=tau)


def _faces(x, alpha, max_rows=MAX_ROWS, fused=True):
    """Each face through both packages' ops: name -> (jax out, torch out)."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    p = {k: t(v) for k, v in x.items()}
    c, k, n = x["lower"].shape
    flat = {s: {w: d[w].reshape(c * k, n) for w in ("lower", "upper")}
            for s, d in (("j", j), ("p", p))}
    out = {
        "scores": (
            (jops.similarity_scores(j["q"], flat["j"]["lower"],
                                    flat["j"]["upper"], alpha=alpha),),
            (tops.similarity_scores(p["q"], flat["p"]["lower"],
                                    flat["p"]["upper"], alpha=alpha),)),
        "two_stage": (
            jops.classify(j["f"] > 0, flat["j"]["lower"], flat["j"]["upper"],
                          j["valid"].reshape(-1), c, alpha=alpha),
            tops.classify(p["f"] > 0, flat["p"]["lower"], flat["p"]["upper"],
                          p["valid"].reshape(-1), c, alpha=alpha)),
        "margins": (
            jops.classify_fused_margins(
                j["f"], j["thr"], j["lower"], j["upper"], j["valid"],
                j["lo"], j["hi"], alpha=alpha, max_rows=max_rows),
            tops.classify_fused_margins(
                p["f"], p["thr"], p["lower"], p["upper"], p["valid"],
                p["lo"], p["hi"], alpha=alpha, max_rows=max_rows)),
        "serve": (
            jops.serve_classify(j["f"], j["table"], j["slot"], j["lower"],
                                j["upper"], j["valid"], j["lo"], j["hi"],
                                j["tau"], alpha=alpha, max_rows=max_rows),
            tops.serve_classify(p["f"], p["table"], p["slot"], p["lower"],
                                p["upper"], p["valid"], p["lo"], p["hi"],
                                p["tau"], alpha=alpha, max_rows=max_rows)),
    }
    if fused:  # B5 keeps the whole bank resident: the resident banks only
        out["classify"] = (
            jops.classify_fused(j["f"], j["thr"], j["lower"], j["upper"],
                                j["valid"], alpha=alpha),
            tops.classify_fused(p["f"], p["thr"], p["lower"], p["upper"],
                                p["valid"], alpha=alpha))
    return out


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("kind", ["binary", "dyadic"])
@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_faces_bit_identical(c, k, kind, alpha):
    x = _with_taus(_case(c + k + len(kind), 12, c, k, N, kind), alpha)
    faces = _faces(x, alpha, fused=(c, k) == RESIDENT)
    for name, (want, got) in faces.items():
        assert_equal_outputs(got, want)
    esc = faces["serve"][1][3].numpy()
    assert esc.any() and not esc.all()


@pytest.mark.parametrize("b,c,k,n", [(37, 30, 2, N), (1, 1, 1, 1),
                                     (16, 12, 4, 64)])
def test_ragged_shapes_bit_identical(b, c, k, n):
    for kind in ("binary", "dyadic"):
        x = _with_taus(_case(b + c, b, c, k, n, kind), 0.37)
        for want, got in _faces(x, 0.37).values():
            assert_equal_outputs(got, want)


@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_edge_windows_and_ties(c, k):
    """Empty window, all-invalid window, exact ties (duplicate windows) and
    a single-valid-class window (margin clamped at 1.0)."""
    b = 6
    x = _case(c + 1, b, c, k, N, "binary")
    x["lower"][1], x["upper"][1] = x["lower"][0], x["upper"][0]  # tie 0/1
    x["valid"][:2] = True
    x["valid"][2] = False  # class 2 has no valid window
    x["valid"][3:5] = True
    x["lo"][:] = [0, 0, 2, 3, 2, 5]
    x["hi"][:] = [0, 2, 3, 4, 4, 9]  # empty, tie, all-invalid, single
    x = _with_taus(x, 0.37)
    faces = _faces(x, 0.37, fused=(c, k) == RESIDENT)
    for want, got in faces.values():
        assert_equal_outputs(got, want)
    pred, per_class, margin, esc = (v.numpy() for v in faces["serve"][1])
    assert pred[0] == 0 and margin[0] == 0.0 and not esc[0]  # empty
    assert margin[1] == 0.0 and pred[1] == 0  # tie -> lowest index
    assert pred[2] == 0 and margin[2] == 0.0  # all-invalid window
    assert pred[3] == 3 and margin[3] == pytest.approx(1.0)  # capped
    assert np.isneginf(per_class[:, 2]).all()


def test_outputs_do_not_depend_on_chunk():
    """Two chunk values (384 and 128 class columns) give the same bits in
    both packages."""
    x = _with_taus(_case(5, 16, *CHUNKED, N, "dyadic"), 0.37)
    cp = layout.padded_classes(CHUNKED[0])
    assert layout.class_chunk(cp, 2, MAX_ROWS) == 384
    assert layout.class_chunk(cp, 2, 256) == 128
    wide = _faces(x, 0.37, MAX_ROWS, fused=False)
    narrow = _faces(x, 0.37, 256, fused=False)
    for name in ("margins", "serve"):
        assert_equal_outputs(narrow[name][1], wide[name][1])
        assert_equal_outputs(narrow[name][1], narrow[name][0])


@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_non_dyadic_windows_within_tolerance(c, k):
    """Real windows: S and margin within rtol 1e-5, atol 1e-6; pred equal
    wherever the JAX top-two gap exceeds 1e-5."""
    x = _with_taus(_case(c * 3 + k, 12, c, k, N, "real"), 0.37)
    for name, (want, got) in _faces(x, 0.37,
                                    fused=(c, k) == RESIDENT).items():
        want = [np.asarray(w) for w in want]
        got = [g.numpy() for g in got]
        scores = want[0] if name == "scores" else want[1]
        np.testing.assert_allclose(
            got[0] if name == "scores" else got[1], scores, rtol=1e-5,
            atol=1e-6, err_msg=name)
        if name == "scores":
            continue
        if len(want) > 2:
            np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-6,
                                       err_msg=name)
            gap = want[2]
        else:
            top = np.sort(want[1], axis=1)
            gap = top[:, -1] - top[:, -2]
        clear = gap > 1e-5
        assert clear.mean() > 0.5, name
        np.testing.assert_array_equal(got[0][clear], want[0][clear],
                                      err_msg=name)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_reference_matches_the_compiled_jax_reference(alpha):
    """The oracle equals the JAX oracle as XLA compiles it (under jit) bit
    for bit on dyadic operands."""
    rng = np.random.default_rng(11)
    lower, upper = dyadic_windows(rng, 7, 3, N)
    q = dyadic(rng, (9, N))
    want = jax.jit(lambda a, b, c: jref(a, b, c, alpha=alpha))(
        jnp.asarray(q), jnp.asarray(lower.reshape(-1, N)),
        jnp.asarray(upper.reshape(-1, N)))
    got = acam_similarity_ref(t(q), t(lower.reshape(-1, N)),
                              t(upper.reshape(-1, N)), alpha=alpha)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest to an exact rational, ties to even."""
    c = np.float32(float(x))
    cands = [c, np.nextafter(c, np.float32(np.inf)),
             np.nextafter(c, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_one_rounds_once():
    """fma_one(alpha, D) is alpha * D + 1 rounded once to f32, including a
    case where rounding the float64 sum first would land on an f32 tie."""
    rng = np.random.default_rng(12)
    alphas = [0.37, 1.0, 1e-3, float(np.float32(1 + 2**-12))]
    dists = np.concatenate([
        dyadic(rng, (64,), 0, 4000, 16.0),
        rng.random(64, dtype=np.float32) * 300,
        np.float32([2**-24 * (1 - 2**-12 + 2**-24), 0.0, 2**-30])])
    for alpha in alphas:
        got = fma_one(alpha, t(dists)).numpy()
        a = Fraction(float(np.float32(alpha)))
        want = np.array([_round_f32(a * Fraction(float(d)) + 1)
                         for d in dists], np.float32)
        np.testing.assert_array_equal(got, want, err_msg=str(alpha))
    # the hard case: float64 gives 1 + 2**-24 (an f32 tie), the exact sum
    # lies above it
    hard = fma_one(float(np.float32(1 + 2**-12)),
                   t(np.float32([2**-24 * (1 - 2**-12 + 2**-24)]))).item()
    assert hard == float(np.float32(1 + 2**-23))


def test_wrapper_counts_no_launch_on_cpu():
    """On CPU tensors a wrapper runs its plain version: no kernel launch."""
    asim.reset_launches()
    x = _with_taus(_case(2, 4, 3, 1, 8, "binary"), 1.0)
    _faces(x, 1.0)
    assert all(v == 0 for v in asim.LAUNCHES.values())


def test_wrapper_rejects_bad_chunk():
    x = _case(4, 4, 3, 1, 8, "binary")
    lo_kcp = layout.stack_kcp(t(x["lower"]), 3)
    with pytest.raises(ValueError, match="chunk"):
        asim.acam_similarity_serve(
            t(x["f"]), t(x["table"]), t(x["slot"]), lo_kcp, lo_kcp,
            layout.valid_kcp(t(x["valid"]), 3), t(x["lo"]), t(x["hi"]),
            torch.zeros(4), 3, chunk=100)


# ---------------------------------------------------------------------------
# The bit-packed arithmetic of the B5 / B6 kernels (`csrc/acam_tiled.cuh`).
# These cases check an identity on a plain mirror of that arithmetic
# (`_torch_parity.packed_hits`), not the kernel, which runs only on the card
# (chip_smoke.py holds it to the plain versions there).
# ---------------------------------------------------------------------------

WINDOW_KINDS = ("binary", "dyadic", "real", "negative_zero", "nan", "mixed")


def _windows(rng, m, n, kind):
    """(lower, upper) (M, N) window rows of ``kind``, and each row's truth:
    is every bound exactly 0 or 1. "negative_zero" is binary with -0.0
    bounds, "nan" real with a NaN bound in each row, "mixed" alternates
    binary and dyadic rows (as a bank can)."""
    lower, upper = binary_windows(rng, m, 1, n)
    lower, upper = lower[:, 0], upper[:, 0]
    binary = np.ones(m, bool)
    if kind == "negative_zero":  # every zero bound is -0.0
        lower = np.where(lower == 0, np.float32(-0.0), lower)
        upper = np.where(upper == 0, np.float32(-0.0), upper)
        assert np.signbit(lower).any() and np.signbit(upper).any()
    elif kind in ("dyadic", "real", "nan", "mixed"):
        if kind == "real":
            lo = rng.standard_normal((m, n), dtype=np.float32) * 0.5
            hi = lo + np.abs(rng.standard_normal((m, n), dtype=np.float32))
        else:
            lo, hi = (w[:, 0] for w in dyadic_windows(rng, m, 1, n))
        if kind == "nan":
            lo[np.arange(m), rng.integers(0, n, m)] = np.nan
        rows = np.arange(m) % 2 == 1 if kind == "mixed" else np.ones(m, bool)
        lower[rows], upper[rows] = lo[rows], hi[rows]
        binary = ~rows | np.array([
            np.isin(lower[i], (0, 1)).all() and np.isin(upper[i], (0, 1)).all()
            for i in range(m)])
    return lower, upper, binary


@pytest.mark.parametrize("n", [1, 64, 300, 1000])
@pytest.mark.parametrize("kind", WINDOW_KINDS)
def test_packed_hits_are_exact(kind, n):
    """The identity the kernels rest on, checked on the mirror: H =
    popc(~q & h0) + popc(q & h1) over the packed planes equals the plain hit
    count for every window kind, the flag is true exactly for the rows whose
    bounds are all 0 or 1, and on those D = N - H exactly, so S from H alone
    is bit-identical to the JAX reference (as XLA compiles it) on the same
    inputs."""
    rng = np.random.default_rng(n + len(kind))
    m = 13
    lower, upper, truth = _windows(rng, m, n, kind)
    q = (rng.random((9, n)) > 0.5).astype(np.float32)
    h0, h1, binary = window_planes(t(lower), t(upper))
    assert binary.tolist() == truth.tolist()
    if kind in ("real", "nan"):
        assert not binary.any()
    if kind == "mixed":
        assert binary.any() and not binary.all()
    hits, dist = hits_and_distance(t(q), t(lower), t(upper))
    got = packed_hits(t(q), h0, h1)
    np.testing.assert_array_equal(got.numpy(), hits.numpy())
    rows = binary.numpy()
    d_bits = (n - got[:, rows]).to(torch.float32)
    np.testing.assert_array_equal(d_bits.numpy(), dist[:, rows].numpy())
    for alpha in ALPHAS:
        want = jax.jit(lambda a, b, c, al=alpha: jref(a, b, c, alpha=al))(
            jnp.asarray(q), jnp.asarray(lower[rows]),
            jnp.asarray(upper[rows]))
        np.testing.assert_array_equal(
            eq11(got[:, rows], d_bits, n, alpha).numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 64, 300, 1000])
def test_packed_planes_mask_the_bits_past_n(n):
    """Bits past N are 0 in both planes and in the query words: ``~q`` is
    1 there, so an unmasked h0 would count the padding as hits."""
    rng = np.random.default_rng(n)
    lower = np.zeros((3, n), np.float32)  # [0, 1] windows: every bit set
    upper = np.ones((3, n), np.float32)
    h0, h1, binary = window_planes(t(lower), t(upper))
    q = pack_words(t(rng.random((2, n)) > 0.5))
    w = -(-n // 32)
    tail = n - 32 * (w - 1)  # valid bits of the last word
    mask = (1 << tail) - 1
    for words in (h0, h1, q):
        last = words[:, -1].to(torch.int64) & 0xFFFFFFFF
        assert bool(((last & ~mask) == 0).all())
    assert bool(((h0[:, -1].to(torch.int64) & 0xFFFFFFFF) == mask).all())
    assert binary.all()
    hits = packed_hits(t(rng.random((2, n)) > 0.5), h0, h1)
    assert bool((hits == n).all())  # every feature hits [0, 1], no more


@pytest.mark.parametrize("b,n,k,c", [(64, 784, 2, 128), (64, 784, 2, 1100),
                                     (256, 784, 1, 10), (5, 100, 3, 7)])
def test_scratch_words_hold_both_planes(b, n, k, c):
    """B5 / B6 scratch: none in the local design (K C up to
    `acam_match.LOCAL_ROWS`), else the feature count's (query bits, one
    plane, window summaries, B counters) plus the second plane, one binary
    flag per template row and one distance per (query, template row)."""
    cp = layout.padded_classes(c)
    w = -(-n // 32)
    want = 0 if k * c <= am.LOCAL_ROWS else (
        (b + 2 * k * cp) * w + k * cp + b * k * cp + 3 * b * -(-c // 32) + b)
    assert asim.scratch_words(b, n, k, cp, c) == want


# ---------------------------------------------------------------------------
# NaN: Eq. 9's max(x, 0) keeps a NaN in both packages (jnp.maximum,
# torch.clamp), so do the max over K and the argmax. The CUDA kernels follow
# the plain versions (chip_smoke.py holds them there); these cases pin the
# plain versions to the JAX package.
# ---------------------------------------------------------------------------

def _nan_case(kind):
    """A (12, 2, N) bank of ``kind`` with a NaN lower bound in class 1 (slice
    0) and a NaN upper bound in class 5 (slice 1), every row valid; windows
    covering class 1, excluding it, or holding class 0 alone."""
    x = _case(31 + len(kind), 6, 12, 2, N, kind)
    x["lower"][1, 0, 7] = np.nan
    x["upper"][5, 1, 40] = np.nan
    x["valid"][:] = True
    x["lo"][:] = [0, 0, 2, 6, 0, 1]
    x["hi"][:] = [12, 12, 5, 12, 1, 2]
    x["q"][2, 9] = np.nan
    x["tau"] = np.full(6, 0.01, np.float32)
    return x


@pytest.mark.parametrize("kind", ["binary", "dyadic"])
def test_nan_scores_match_jax(kind):
    """B7b: a NaN window bound gives NaN in its template row's column for
    every query, a NaN query NaN in its row; elsewhere bit-identical."""
    x = _nan_case(kind)
    n = x["lower"].shape[-1]
    lo, hi = x["lower"].reshape(-1, n), x["upper"].reshape(-1, n)
    want = np.asarray(jops.similarity_scores(
        jnp.asarray(x["q"]), jnp.asarray(lo), jnp.asarray(hi)))
    got = tops.similarity_scores(t(x["q"]), t(lo), t(hi)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where NaN
    nan_cols = [1 * 2 + 0, 5 * 2 + 1]  # class-major rows c * K + k
    assert np.isnan(want[:, nan_cols]).all() and np.isnan(want[2]).all()
    rest = np.delete(np.delete(want, nan_cols, axis=1), 2, axis=0)
    assert not np.isnan(rest).any()


@pytest.mark.parametrize("kind", ["binary", "dyadic"])
@pytest.mark.parametrize("c,k", [RESIDENT, CHUNKED])
def test_nan_bounds_classify_and_serve_match_jax(c, k, kind):
    """B5 and B6 with NaN bounds in classes 1 and 5: per_class NaN there,
    pred the lowest NaN class in the row's window, margin 0 and escalate
    (margin < tau) wherever the window holds a NaN class, as in both
    packages; windows without one decide as usual."""
    x = _nan_case(kind)
    if (c, k) == CHUNKED:  # the NaN classes inside a 1,100-class bank
        big = _case(37, 6, c, k, N, kind)
        for f in ("lower", "upper"):
            big[f][:12] = x[f]
        big["valid"][:] = True
        x.update(lower=big["lower"], upper=big["upper"], valid=big["valid"])
        x["hi"][:] = [12, c, 5, c, 1, 2]
    faces = _faces(x, 1.0, fused=(c, k) == RESIDENT)
    for name in ("classify", "margins", "serve"):
        if name not in faces:
            continue
        want, got = faces[name]
        assert_equal_outputs(got, want)
        per_class = np.asarray(want[1])
        assert np.isnan(per_class[:, [1, 5]]).all(), name
        assert not np.isnan(np.delete(per_class, [1, 5], axis=1)).any()
    pred, _, margin, esc = (np.asarray(v) for v in faces["serve"][0])
    assert pred.tolist()[:3] == [1, 1, 2] and pred[5] == 1
    assert (margin[[0, 1, 5]] == 0).all() and esc[[0, 1, 5]].all()
    assert pred[4] == 0 and margin[4] == 1.0  # class 0 alone
    assert np.isfinite(margin).all()


# ---------------------------------------------------------------------------
# B7b at the edges of the CUDA kernel's tiles (`csrc/acam_similarity.cu`,
# sim_tile_kernel): 2 queries x 12 rows with 128-feature slices, or 8 x 16
# with 64-feature slices where the grid fills the card. The plain version
# the kernel is held to on the card, against the jitted JAX kernel.
# ---------------------------------------------------------------------------

TILE_EDGES = [(1, 1, 1), (1, 12, 128), (3, 11, 127), (2, 13, 129),
              (7, 15, 63), (9, 17, 65), (8, 16, 64), (5, 2, 100)]


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("b,m,n", TILE_EDGES)
def test_scores_at_tile_edges(b, m, n, alpha):
    """Binary windows with -0.0 zero bounds, and dyadic windows: the plain
    version equals the JAX Pallas kernel (interpret) bit for bit."""
    rng = np.random.default_rng(b * 1000 + m * 10 + n)
    q = dyadic(rng, (b, n))
    for kind in ("negative_zero", "dyadic"):
        if kind == "negative_zero":  # binary, every zero bound -0.0
            lower, upper = (w[:, 0] for w in binary_windows(rng, m, 1, n))
            lower.flat[0] = 0.0  # at least one zero bound
            lower, upper = (np.where(w == 0, np.float32(-0.0), w)
                            for w in (lower, upper))
        else:
            lower, upper, _ = _windows(rng, m, n, kind)
        want = np.asarray(jsim(jnp.asarray(q), jnp.asarray(lower),
                               jnp.asarray(upper), alpha=alpha,
                               interpret=True))
        got = asim.similarity_plain(t(q), t(lower), t(upper),
                                    alpha=alpha).numpy()
        np.testing.assert_array_equal(got, want, err_msg=kind)
