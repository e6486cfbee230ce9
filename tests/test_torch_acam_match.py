"""The port's acam_match kernels (B1-B4) against the JAX package's.

The same numpy inputs go through `repro.kernels.acam_match.ops` (Pallas in
interpret mode on the CPU) and `repro_torch.kernels.acam_match.ops` (the
plain PyTorch versions on the CPU). Match counts are integers, so pred,
per_class, margin and escalate must be bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_equal_outputs, binary_bank, t
from repro.kernels.acam_match import ops as jops
from repro_torch.kernels import layout
from repro_torch.kernels.acam_match import acam_match as am
from repro_torch.kernels.acam_match import ops as tops
from repro_torch.kernels.acam_match.ref import acam_match_ref

MAX_ROWS = 2048
T_ROWS = 8


def _case(seed, b, c, k, n):
    """Features, thresholds, a {0,1} bank, windows (row 0 empty), slots, a
    thresholds table and taus straddling every margin (-inf on row 0, as
    the scheduler pads)."""
    rng = np.random.default_rng(seed)
    x = binary_bank(rng, c, k, n)
    lo = rng.integers(0, max(c - 4, 1), size=b)
    hi = np.minimum(lo + rng.integers(1, c + 1, size=b), c)
    hi[0] = lo[0]
    x.update(
        f=rng.standard_normal((b, n), dtype=np.float32),
        thr=(rng.standard_normal(n, dtype=np.float32) * 0.1),
        lo=lo.astype(np.int32), hi=hi.astype(np.int32),
        table=(rng.standard_normal((T_ROWS, n), dtype=np.float32) * 0.1),
        slot=rng.integers(0, T_ROWS, size=b).astype(np.int32))
    return x


def _with_taus(x):
    margins = np.asarray(jops.serve_classify(
        jnp.asarray(x["f"]), jnp.asarray(x["table"]), jnp.asarray(x["slot"]),
        jnp.asarray(x["templates"]), jnp.asarray(x["valid"]),
        jnp.asarray(x["lo"]), jnp.asarray(x["hi"]), max_rows=MAX_ROWS)[2])
    sign = np.where(np.arange(len(margins)) % 2 == 0, 0.5, -0.5)
    tau = (margins + sign).astype(np.float32)
    tau[0] = -np.inf  # a padding row never escalates
    return dict(x, tau=tau)


def _faces(x, max_rows=MAX_ROWS):
    """Each face through both packages' ops: name -> (jax out, torch out)."""
    j = {k: jnp.asarray(v) for k, v in x.items()}
    p = {k: t(v) for k, v in x.items()}
    return {
        "classify": (
            jops.classify_fused(j["f"], j["thr"], j["templates"], j["valid"]),
            tops.classify_fused(p["f"], p["thr"], p["templates"],
                                p["valid"])),
        "margins": (
            jops.classify_fused_margins(j["f"], j["thr"], j["templates"],
                                        j["valid"], j["lo"], j["hi"]),
            tops.classify_fused_margins(p["f"], p["thr"], p["templates"],
                                        p["valid"], p["lo"], p["hi"])),
        "chunked": (
            jops.classify_fused_margins_chunked(
                j["f"], j["thr"], j["templates"], j["valid"], j["lo"],
                j["hi"], max_rows=max_rows),
            tops.classify_fused_margins_chunked(
                p["f"], p["thr"], p["templates"], p["valid"], p["lo"],
                p["hi"], max_rows=max_rows)),
        "serve": (
            jops.serve_classify(j["f"], j["table"], j["slot"], j["templates"],
                                j["valid"], j["lo"], j["hi"], j["tau"],
                                max_rows=max_rows),
            tops.serve_classify(p["f"], p["table"], p["slot"], p["templates"],
                                p["valid"], p["lo"], p["hi"], p["tau"],
                                max_rows=max_rows)),
    }


# (b, c, k, n): tests/test_kernels.py's ragged and degenerate shapes, the
# resident (12, 4) and chunked (1100, 2) banks of the serve mega-kernel tests
SHAPES = [(37, 30, 2, 300), (1, 1, 1, 1), (16, 12, 4, 64), (16, 1100, 2, 64)]


@pytest.mark.parametrize("b,c,k,n", SHAPES)
def test_faces_bit_identical(b, c, k, n):
    x = _with_taus(_case(b * 7 + c, b, c, k, n))
    for name, (want, got) in _faces(x).items():
        assert_equal_outputs(got, want)
        if name == "serve" and b > 2:
            esc = want[3]
            assert np.asarray(esc).any() and not np.asarray(esc).all()


def test_edge_windows_and_ties():
    """Empty window, all-invalid window, exact ties (duplicate templates)
    and a single-valid-class window (margin = N), resident and chunked."""
    for c, k in ((12, 4), (1100, 2)):
        b, n = 6, 64
        x = _case(c + 1, b, c, k, n)
        x["templates"][1] = x["templates"][0]  # classes 0 and 1 tie
        x["valid"][:3] = True
        x["valid"][2] = False  # class 2 has no valid template
        x["valid"][3:5] = [True] * k
        x["lo"][:] = [0, 0, 2, 3, 2, 5]
        x["hi"][:] = [0, 2, 3, 4, 4, 9]  # empty, tie, all-invalid, single
        x = _with_taus(x)
        faces = _faces(x)
        for want, got in faces.values():
            assert_equal_outputs(got, want)
        pred, _, margin, esc = (np.asarray(v) for v in faces["serve"][1])
        assert pred[0] == 0 and margin[0] == 0.0 and not esc[0]  # empty
        assert margin[1] == 0.0 and pred[1] == 0  # tie -> lowest index
        assert pred[2] == 0 and margin[2] == 0.0  # all-invalid window
        assert margin[3] == n  # one valid class: clamped to N


def test_outputs_do_not_depend_on_chunk():
    """Two chunk values (384 and 128 class columns) give the same bits in
    both packages."""
    x = _with_taus(_case(5, 16, 1100, 2, 64))
    cp = layout.padded_classes(1100)
    assert layout.class_chunk(cp, 2, MAX_ROWS) == 384
    assert layout.class_chunk(cp, 2, 256) == 128
    wide, narrow = _faces(x, MAX_ROWS), _faces(x, 256)
    for name in ("chunked", "serve"):
        assert_equal_outputs(narrow[name][1], wide[name][1])
        assert_equal_outputs(narrow[name][1], narrow[name][0])


def test_layouts_match_jax():
    from repro.kernels import layout as jlayout

    rng = np.random.default_rng(3)
    x = binary_bank(rng, 130, 3, 16)
    for jf, tf in ((jlayout.flatten_kmajor, layout.flatten_kmajor),
                   (jlayout.stack_kcp, layout.stack_kcp)):
        np.testing.assert_array_equal(
            np.asarray(jf(jnp.asarray(x["templates"]), 130)),
            tf(t(x["templates"]), 130).numpy())
    for jf, tf in ((jlayout.valid_kmajor, layout.valid_kmajor),
                   (jlayout.valid_kcp, layout.valid_kcp)):
        np.testing.assert_array_equal(
            np.asarray(jf(jnp.asarray(x["valid"]), 130)),
            tf(t(x["valid"]), 130).numpy())
    for cp, k, rows in ((1152, 2, 2048), (128, 4, 2048), (256, 20, 2048)):
        assert layout.class_chunk(cp, k, rows) == \
            jlayout.class_chunk(cp, k, rows)


def test_plain_counts_match_the_oracle():
    """The bipolar count of the plain versions equals the direct count
    sum_i 1(q_i == t_i) of the oracle."""
    rng = np.random.default_rng(9)
    f = t(rng.standard_normal((9, 37), dtype=np.float32))
    thr = t(rng.standard_normal(37, dtype=np.float32))
    templates = t((rng.random((5, 37)) > 0.5).astype(np.float32))
    np.testing.assert_array_equal(
        am._counts(f > thr, templates).numpy(),
        acam_match_ref(f, thr, templates).numpy())


def test_wrapper_counts_no_launch_on_cpu():
    """On CPU tensors a wrapper runs its plain version: no kernel launch."""
    am.reset_launches()
    x = _with_taus(_case(2, 4, 3, 1, 8))
    _faces(x)
    assert all(v == 0 for v in am.LAUNCHES.values())


def test_wrapper_rejects_bad_chunk():
    x = _case(4, 4, 3, 1, 8)
    with pytest.raises(ValueError, match="chunk"):
        am.acam_match_classify_margins_chunked(
            t(x["f"]), t(x["thr"]), layout.stack_kcp(t(x["templates"]), 3),
            layout.valid_kcp(t(x["valid"]), 3), t(x["lo"]), t(x["hi"]), 3,
            chunk=100)
