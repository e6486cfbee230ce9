"""The port's acam_match kernels (B1-B4, B7a) against the JAX package's.

The same numpy inputs go through `repro.kernels.acam_match.ops` (Pallas in
interpret mode on the CPU) and `repro_torch.kernels.acam_match.ops` (the
plain PyTorch versions on the CPU). Match counts are integers, so pred,
per_class, margin and escalate must be bit-identical.
"""
import ctypes
import importlib
import re
from pathlib import Path

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


@pytest.mark.parametrize("b,c,k,n", [(37, 30, 2, 100), (1, 1, 1, 1),
                                     (16, 12, 4, 64)])
def test_raw_counts_and_two_stage_classify_bit_identical(b, c, k, n):
    """B7a: `match_scores` (raw (B, M) counts) and the two-stage `classify`
    over a class-major flattened bank, with the valid mask, the max over K
    and the WTA in the epilogue."""
    x = _case(b + c + k, b, c, k, n)
    flat = x["templates"].reshape(c * k, n)
    np.testing.assert_array_equal(
        tops.match_scores(t(x["f"]), t(x["thr"]), t(flat)).numpy(),
        np.asarray(jops.match_scores(jnp.asarray(x["f"]),
                                     jnp.asarray(x["thr"]),
                                     jnp.asarray(flat))))
    assert_equal_outputs(
        tops.classify(t(x["f"]), t(x["thr"]), t(flat),
                      t(x["valid"].reshape(-1)), c),
        jops.classify(jnp.asarray(x["f"]), jnp.asarray(x["thr"]),
                      jnp.asarray(flat), jnp.asarray(x["valid"].reshape(-1)),
                      c))


def test_raw_counts_wrapper_runs_plain_on_cpu():
    am.reset_launches()
    x = _case(6, 5, 4, 1, 40)
    flat = t(x["templates"].reshape(4, 40))
    np.testing.assert_array_equal(
        am.acam_match(t(x["f"]), t(x["thr"]), flat).numpy(),
        acam_match_ref(t(x["f"]), t(x["thr"]), flat).numpy())
    assert am.LAUNCHES["acam_match"] == 0


def _tile_boundary_case(seed, b, c, k, n):
    """Rows 1-10 share one query, which the duplicated templates of classes
    e - 1 and e at every class-tile boundary e (multiples of B2's
    `CLASS_TILE`) match exactly: ties split across a boundary, and windows
    that start and end on boundaries. Returns (inputs, {row: (expected
    pred, expected margin or None)})."""
    ct = am.CLASS_TILE
    edges = list(range(ct, c, ct))
    last = edges[-1]
    x = _case(seed, b, c, k, n)
    x["f"][1:11] = x["f"][1]
    q1 = (x["f"][1] > x["thr"]).astype(np.float32)
    for e in edges:
        x["templates"][e - 1:e + 1] = q1[None, None, :]
        x["valid"][e - 1:e + 1] = True
    x["valid"][ct + 5] = False  # an all-invalid class
    rows = {1: ((0, c), ct - 1, 0.0), 2: ((ct, 2 * ct), ct, 0.0),
            3: ((ct - 1, ct + 1), ct - 1, 0.0),
            4: ((ct + 1, 2 * ct), 2 * ct - 1, None),
            5: ((last, c), last, None), 6: ((ct, ct), 0, 0.0),
            7: ((ct + 5, ct + 6), 0, 0.0), 8: ((0, ct), ct - 1, None),
            9: ((2 * ct, last), 2 * ct, 0.0),
            10: ((last - 1, last + 1), last - 1, 0.0)}
    for row, ((lo, hi), _, _) in rows.items():
        x["lo"][row], x["hi"][row] = lo, hi
    for row in range(11, b):  # windows that start and end on tile edges
        lo = edges[row % len(edges)] * (row % 2)
        x["lo"][row], x["hi"][row] = lo, min(c, lo + ct * (1 + row % 5))
    return x, {row: want for row, (_, *want) in rows.items()}


# (b, c, k, n): the big-bank main path, then B not a multiple of the query
# tile and C not one of the class tile at K 1-4 and N 64 / 1000
@pytest.mark.parametrize("b,c,k,n", [(64, 1100, 2, 784), (37, 1100, 1, 64),
                                     (37, 300, 3, 1000), (21, 100, 4, 64)])
def test_chunked_bit_identical_at_class_tile_boundaries(b, c, k, n):
    """B2's plain route against the JAX package's chunked classify (Pallas,
    interpret mode), with ties and windows on the card kernel's class-tile
    boundaries; the decisions also match the ties' expected winners."""
    x, want = _tile_boundary_case(b + 3 * c + k, b, c, k, n)
    j = {key: jnp.asarray(v) for key, v in x.items()}
    p = {key: t(v) for key, v in x.items()}
    jax_out = jops.classify_fused_margins_chunked(
        j["f"], j["thr"], j["templates"], j["valid"], j["lo"], j["hi"],
        max_rows=MAX_ROWS)
    got = tops.classify_fused_margins_chunked(
        p["f"], p["thr"], p["templates"], p["valid"], p["lo"], p["hi"],
        max_rows=MAX_ROWS)
    assert_equal_outputs(got, jax_out, names=("pred", "per_class", "margin"))
    pred, margin = got[0].tolist(), got[2].tolist()
    for row, (want_pred, want_margin) in want.items():
        assert pred[row] == want_pred, (row, pred[row], want_pred)
        assert want_margin is None or margin[row] == want_margin, row


def test_b2_tiles_fit_the_bank_layout():
    """The card kernel needs Cp to be a multiple of its class tile, and one
    scratch buffer holds the bits, the tile summaries and the counters."""
    assert layout.LANE % am.CLASS_TILE == 0
    assert layout.padded_classes(1100) % am.CLASS_TILE == 0
    # (64 + 2 * 1152) rows of 25 words, 64 rows x 35 tiles x 3 words, one
    # counter per query tile
    assert am.b2_scratch_words(64, 784, 2, 1152, 1100) == \
        2368 * 25 + 64 * 35 * 3 + 64 // am.QUERY_TILE


def _tiled_case(seed, b, c, k, n):
    """`_tile_boundary_case` for B1 and B3: rows 1-10 also share the serve
    tick's slot 0, whose threshold row is ``thr``, and the taus straddle
    every margin (-inf on row 0, a padding row)."""
    x, want = _tile_boundary_case(seed, b, c, k, n)
    x["slot"][1:11] = 0
    x["table"][0] = x["thr"]
    return _with_taus(x), want


# (b, c, k, n): banks inside MAX_FUSED_ROWS whose classes cross several
# class tiles (C 100 and 130 are no multiple of 32), B no multiple of the
# query tile, K 1-4, N 64 / 784 / 1000
TILED_SHAPES = [(21, 100, 1, 784), (21, 130, 2, 1000), (37, 100, 4, 64),
                (21, 130, 3, 64)]


@pytest.mark.parametrize("b,c,k,n", TILED_SHAPES)
def test_classify_bit_identical_at_class_tile_boundaries(b, c, k, n):
    """B1's plain route against the JAX package's fused classify (Pallas,
    interpret mode) with exact ties on both sides of every class-tile
    boundary: rows 1-10 pick the lowest tied class and score N there."""
    x, _ = _tiled_case(b + 5 * c + k, b, c, k, n)
    ct = am.CLASS_TILE
    ties = [e + d for e in range(ct, c, ct) for d in (-1, 0)]
    got = tops.classify_fused(t(x["f"]), t(x["thr"]), t(x["templates"]),
                              t(x["valid"]))
    assert_equal_outputs(got, jops.classify_fused(
        jnp.asarray(x["f"]), jnp.asarray(x["thr"]),
        jnp.asarray(x["templates"]), jnp.asarray(x["valid"])),
        names=("pred", "per_class"))
    pred, per_class = got[0].numpy(), got[1].numpy()
    assert (pred[1:11] == ct - 1).all(), pred[1:11]
    assert (per_class[1:11][:, ties] == n).all()
    assert (per_class[1:11, ct + 5] == -np.inf).all()  # all invalid


@pytest.mark.parametrize("b,c,k,n", TILED_SHAPES)
def test_serve_bit_identical_at_class_tile_boundaries(b, c, k, n):
    """B3's plain route against the JAX package's serve tick (Pallas,
    interpret mode) with ties and windows on the class-tile boundaries; the
    decisions match the expected winners, and the padding row never
    escalates."""
    x, want = _tiled_case(b + 7 * c + k, b, c, k, n)
    jax_out, got = _faces(x)["serve"]
    assert_equal_outputs(got, jax_out)
    pred, margin, esc = (v.tolist() for v in (got[0], got[2], got[3]))
    for row, (want_pred, want_margin) in want.items():
        assert pred[row] == want_pred, (row, pred[row], want_pred)
        assert want_margin is None or margin[row] == want_margin, row
    assert not esc[0] and any(esc) and not all(esc[1:])


@pytest.mark.parametrize("b,c,k,n", TILED_SHAPES)
def test_classify_margins_bit_identical_at_class_tile_boundaries(b, c, k, n):
    """B4's plain route against the JAX package's fused classify with
    margins (Pallas, interpret mode), with ties and windows on the
    class-tile boundaries; the decisions match the expected winners."""
    x, want = _tiled_case(b + 11 * c + k, b, c, k, n)
    jax_out, got = _faces(x)["margins"]
    assert_equal_outputs(got, jax_out, names=("pred", "per_class", "margin"))
    pred, margin = got[0].tolist(), got[2].tolist()
    for row, (want_pred, want_margin) in want.items():
        assert pred[row] == want_pred, (row, pred[row], want_pred)
        assert want_margin is None or margin[row] == want_margin, row


# (b, m, n): one to nine of the card kernel's 32-row class tiles and more
# (M past 256 needs several class groups per query group), the last tile
# ragged, B no multiple of the query tile
@pytest.mark.parametrize("b,m,n", [(21, 100, 784), (37, 260, 64),
                                   (13, 771, 1000), (5, 2200, 64)])
def test_raw_counts_bit_identical_across_class_tiles(b, m, n):
    """B7a's plain route against the JAX package's `match_scores` (Pallas,
    interpret mode) over an (M, N) bank whose rows e - 1 and e of every
    class-tile boundary e duplicate row 1's binarised query: those columns
    count N on rows 1-3, which share that query."""
    rng = np.random.default_rng(m + n)
    f = rng.standard_normal((b, n), dtype=np.float32)
    thr = rng.standard_normal(n, dtype=np.float32) * 0.1
    f[1:4] = f[1]
    bank = (rng.random((m, n)) > 0.5).astype(np.float32)
    ties = [r for e in range(am.CLASS_TILE, m, am.CLASS_TILE)
            for r in (e - 1, e)]
    bank[ties] = (f[1] > thr).astype(np.float32)
    got = tops.match_scores(t(f), t(thr), t(bank)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.match_scores(jnp.asarray(f), jnp.asarray(thr),
                                          jnp.asarray(bank))))
    assert got.shape == (b, m)
    assert (got[1:4][:, ties] == n).all()
    assert (got[0] < n).any()


@pytest.mark.parametrize("c,k", [(128, 2), (10, 1)])
def test_serve_out_of_table_slots_read_zero_thresholds(c, k):
    """Slots -1, T and T + 5 lie outside the (T, N) thresholds table: both
    packages binarise those rows against zeros (the TPU kernel's one-hot
    select), so they count f > 0."""
    b, n = 24, 784
    x = _case(40 + c, b, c, k, n)
    x["slot"][1::4] = np.resize([-1, T_ROWS, T_ROWS + 5], len(x["slot"][1::4]))
    x = _with_taus(x)
    jax_out, got = _faces(x)["serve"]
    assert_equal_outputs(got, jax_out)
    rows = np.arange(1, b, 4)
    zero_thr = tops.classify_fused(t(x["f"][rows]), t(np.zeros(n, np.float32)),
                                   t(x["templates"]), t(x["valid"]))[1]
    np.testing.assert_array_equal(got[1].numpy()[rows], zero_thr.numpy())


@pytest.mark.parametrize("b,n,k,c,local", [
    (64, 784, 2, 128, False),  # the serve tick (B3), cooperative
    (256, 784, 1, 10, True),   # predict (B1), local: no scratch
    (21, 1000, 3, 130, False), (1, 1, 1, 1, True)])
def test_tiled_layout_words_and_alignment(b, n, k, c, local):
    """The tiled faces' one buffer: pred, per_class, margin, the
    cooperative scratch and escalate's bytes (B1: no margin; B4: no
    escalate; B3 both), each view aligned to its element size (the scratch
    to the 4-byte acam::Top it holds) and inside the buffer; B7a's raw
    counts over the flattened (C K, N) bank, then its bits-only scratch.
    `_scratch` picks the design: the compose tick (64, 128, 2) cooperative,
    `ACAMHead.scores` (256, 10, 1) local."""
    cp = layout.padded_classes(c)
    w, tiles = -(-n // 32), -(-c // am.CLASS_TILE)
    scratch = am._scratch(b, n, k, cp, c)
    assert scratch == (0 if local else (b + k * cp) * w + 3 * b * tiles + b)
    assert scratch == (0 if local else am.scratch_words(b, n, k, cp, c, b))
    assert am.b2_scratch_words(b, n, k, cp, c) == \
        am.scratch_words(b, n, k, cp, c, -(-b // am.QUERY_TILE))
    m = k * c
    m_cp = -(-m // am.CLASS_TILE) * am.CLASS_TILE
    raw_scratch = am._scratch(b, n, 1, m_cp, m, raw=True)
    assert raw_scratch == (0 if local else (b + m_cp) * w)
    raw = am.tiled_layout(b, m, margin=False, scratch=raw_scratch,
                          escalate=False, pred=False)
    assert raw.per_class == 0 and raw.margin is None and raw.escalate is None
    assert raw.words == b * m + raw_scratch
    assert (raw.scratch is None) == local
    assert local or raw.scratch == 4 * b * m
    for margin, escalate in ((False, False), (True, False), (True, True)):
        lay = am.tiled_layout(b, c, margin=margin, scratch=scratch,
                              escalate=escalate)
        ends = [(0, 4 * b), (lay.per_class, lay.per_class + 4 * b * c)]
        if margin:
            ends.append((lay.margin, lay.margin + 4 * b))
        if scratch:
            ends.append((lay.scratch, lay.scratch + 4 * scratch))
        if escalate:
            ends.append((lay.escalate, lay.escalate + b))
        assert lay.words == b + b * c + (b if margin else 0) + scratch + (
            -(-b // 4) if escalate else 0)
        for (start, end), nxt in zip(ends, ends[1:] + [(4 * lay.words,)]):
            assert start % 4 == 0 and end <= nxt[0]  # aligned, no overlap
        assert (lay.margin is None) != margin
        assert (lay.scratch is None) != bool(scratch)
        assert (lay.escalate is None) != escalate


def _c_entries(source: Path) -> dict[str, list]:
    """Each ``extern "C"`` entry of a CUDA source -> the ctypes type of
    each argument: a pointer as c_void_p, an int as c_int, a float as
    c_float."""
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                   source.read_text()):
        types = []
        for param in params.split(","):
            decl = " ".join(param.split()[:-1])
            types.append(ctypes.c_void_p if "*" in param else kinds[decl])
        entries[name] = types
    return entries


CSRC = Path(am.__file__).resolve().parents[2] / "csrc"


@pytest.mark.parametrize("source", ["acam_match", "acam_similarity",
                                    "kd_loss", "flash_attention",
                                    "student_epilogue"])
def test_ctypes_signatures_match_the_cuda_entry_points(source):
    """Every C entry of ``csrc/<source>.cu`` has a ctypes signature in its
    wrapper module with the same count and kinds of arguments, the stream
    last: ctypes raises on a wrong count only, and a wrong kind launches on
    garbage."""
    entries = _c_entries(CSRC / f"{source}.cu")
    module = importlib.import_module(
        f"repro_torch.kernels.{source}.{source}")
    assert entries and set(entries) == set(module._SIGNATURES)
    for name, types in entries.items():
        assert module._SIGNATURES[name] == types, name
        assert types[-1] is ctypes.c_void_p, name  # the stream
