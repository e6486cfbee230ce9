"""ACAM feature-count kernels (paper Eq. 8 + Eq. 12), five faces.

Each face keeps the signature of its Pallas TPU counterpart in
`repro/kernels/acam_match/acam_match.py` (K-major ``(K * Cp, N)`` or
``(K, Cp, N)`` template operands, ``num_classes``, ``chunk``) and comes in
two versions in this module:

  * a **plain PyTorch** version (``*_plain``): binarise, the bipolar count
    ``(N + Q~ . T~^T) / 2`` (exact: +/-1 products summed in f32), the valid
    mask, the per-class max over K, and the `layout` epilogues;
  * a **CUDA wrapper** (the un-suffixed name) over `csrc/acam_match.cu`.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Each launch adds one to its face's
entry in `LAUNCHES`, so a run can show that its main path went through the
kernels.

    face                                  TPU kernel replaced (acam_match.py)
    acam_match_classify                   _classify_kernel                  B1
    acam_match_classify_margins           _classify_margins_kernel          B4
    acam_match_classify_margins_chunked   _classify_margins_chunked_kernel  B2
    acam_match_serve                      _serve_kernel                     B3
    acam_match                            _kernel (raw (B, M) counts)       B7a

Templates must be {0, 1} (every producer binarises them). The chunked faces
accept ``chunk`` for signature parity; on the card it changes nothing.

Every face is one launch of the tiled design: a warp counts one query
against `CLASS_TILE` classes, one per lane, and window summaries merge
exactly across tiles. B2 (its own kernel, `QUERY_TILE` queries by one class
tile per block), and B1, B3, B4 and B7a on banks past `LOCAL_ROWS` template
rows, take the cooperative design: a pack into bit scratch, a grid sync,
the count, and a merge of the class tiles' summaries (inside the block up
to 8 tiles; past that the last tile to arrive merges). On smaller banks
they take the local design: one block per query group binarises straight
into shared memory, with no grid sync and no scratch. B7a is the same
kernel's raw mode: every row of its unpadded (M, N) bank counts, and the
counts are the output; its design is the tuning table's
(`repro_torch.kernels.tuning`, whose default is the `LOCAL_ROWS` rule) or
the caller's ``block``. Each wrapper makes one allocation (outputs, then
scratch, then B3's escalate bytes; `tiled_layout`) and takes the output
views after the launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, layout, tuning

#: the tiled kernel's tiles (``kCT``, ``kQT`` in csrc/acam_match.cu): a
#: block counts QUERY_TILE queries against CLASS_TILE classes at a time, and
#: the decision merges one window summary per class tile
CLASS_TILE = 32
QUERY_TILE = 8
#: B1 and B3 take the tiled kernel's local design for banks of up to this
#: many template rows (K * C; each block binarises them, once per query
#: group) and its cooperative design past it
LOCAL_ROWS = 16

#: kernel launches per face since the last `reset_launches()`
LAUNCHES = {"acam_match_classify": 0, "acam_match_classify_margins": 0,
            "acam_match_classify_margins_chunked": 0, "acam_match_serve": 0,
            "acam_match": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

def _counts(q: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """(B, M) match counts of bool queries (B, N) against {0,1} templates
    (M, N): +/-1 products sum to integers, exact in f32 below 2**24."""
    q_pm = q.to(torch.float32) * 2.0 - 1.0
    t_pm = templates.to(torch.float32) * 2.0 - 1.0
    return (q_pm @ t_pm.T + q.shape[-1]) * 0.5


def match_plain(features, thresholds, templates):
    return _counts(features > thresholds, templates)


def _margins_plain(q, templates_kmajor, valid_row, class_lo, class_hi,
                   num_classes):
    cp = layout.padded_classes(num_classes)
    scores = _counts(q, templates_kmajor)
    per_class, _ = layout.wta_epilogue(scores, valid_row[None, :], cp,
                                       templates_kmajor.shape[0] // cp)
    pred, margin = layout.windowed_margin(
        per_class, class_lo.to(torch.int32)[:, None],
        class_hi.to(torch.int32)[:, None], float(q.shape[-1]))
    return pred, per_class[:, :num_classes], margin


def classify_plain(features, thresholds, templates_kmajor, valid_row,
                   num_classes):
    cp = layout.padded_classes(num_classes)
    scores = _counts(features > thresholds, templates_kmajor)
    per_class, pred = layout.wta_epilogue(scores, valid_row[None, :], cp,
                                          templates_kmajor.shape[0] // cp)
    return pred, per_class[:, :num_classes]


def classify_margins_plain(features, thresholds, templates_kmajor, valid_row,
                           class_lo, class_hi, num_classes):
    return _margins_plain(features > thresholds, templates_kmajor, valid_row,
                          class_lo, class_hi, num_classes)


def classify_margins_chunked_plain(features, thresholds, templates_kcp,
                                   valid_kcp, class_lo, class_hi, num_classes,
                                   *, chunk):
    _check_chunk(templates_kcp.shape[1], chunk)
    return _margins_plain(features > thresholds,
                          templates_kcp.reshape(-1, templates_kcp.shape[-1]),
                          valid_kcp.reshape(-1), class_lo, class_hi,
                          num_classes)


def _slot_thresholds(thr_table, tenant_slot):
    """Each row's threshold row; a slot outside the table reads zeros, as
    the TPU kernel's one-hot select does."""
    t = thr_table.shape[0]
    slot = tenant_slot.to(torch.int64)
    inside = (slot >= 0) & (slot < t)
    rows = thr_table[slot.clamp(0, t - 1)]
    return torch.where(inside[:, None], rows, torch.zeros_like(rows))


def serve_plain(features, thr_table, tenant_slot, templates_kcp, valid_kcp,
                class_lo, class_hi, tau, num_classes, *, chunk):
    _check_chunk(templates_kcp.shape[1], chunk)
    q = (features - _slot_thresholds(thr_table, tenant_slot)) > 0
    pred, per_class, margin = _margins_plain(
        q, templates_kcp.reshape(-1, templates_kcp.shape[-1]),
        valid_kcp.reshape(-1), class_lo, class_hi, num_classes)
    return pred, per_class, margin, margin < tau


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # f, thr, t, valid, B, N, K, Cp, C, scratch, pred, per_class, stream
    "acam_match_classify": [_P] * 4 + [_I] * 5 + [_P] * 4,
    # f, thr, t, valid, lo, hi, B, N, K, Cp, C, scratch, pred, per_class,
    # margin, stream
    "acam_match_classify_margins": [_P] * 6 + [_I] * 5 + [_P] * 5,
    # f, thr, t, valid, lo, hi, B, N, K, Cp, C, chunk, scratch, pred,
    # per_class, margin, stream
    "acam_match_classify_margins_chunked": [_P] * 6 + [_I] * 6 + [_P] * 5,
    # f, thr_table, thr_rows, slot, t, valid, lo, hi, tau, B, N, K, Cp, C,
    # chunk, scratch, pred, per_class, margin, esc, stream
    "acam_match_serve": [_P, _P, _I] + [_P] * 6 + [_I] * 6 + [_P] * 6,
    # f, thr, t, B, N, M, scratch, out, stream
    "acam_match": [_P] * 3 + [_I] * 3 + [_P] * 3,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("acam_match", _SIGNATURES)


def _check_chunk(cp: int, chunk: int) -> None:
    if chunk < 1 or cp % chunk:
        raise ValueError(f"chunk={chunk} must divide the padded class "
                         f"count {cp}")


def _check(name: str, x: torch.Tensor, device: torch.device,
           dtype: torch.dtype, shape: tuple[int, ...]) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    """Call face ``name`` (pointers and ints) on ``device``'s current
    stream; raise on a CUDA error."""
    _build.launch(_lib(), name, device, LAUNCHES, *args)


def scratch_words(b: int, n: int, k: int, cp: int, c: int,
                  counters: int) -> int:
    """int32 words of a cooperative tiled launch's scratch: the query bits
    (B, W), the template bits (K * Cp, W), 3 words of window summary per
    (row, class tile) and ``counters`` arrival counters."""
    w = -(-n // 32)
    return (b + k * cp) * w + 3 * b * -(-c // CLASS_TILE) + counters


def b2_scratch_words(b: int, n: int, k: int, cp: int, c: int) -> int:
    """B2's scratch: one arrival counter per query tile."""
    return scratch_words(b, n, k, cp, c, -(-b // QUERY_TILE))


class TiledLayout(NamedTuple):
    """Byte offsets into a tiled face's one buffer of 4-byte words (pred,
    int32, at 0 where it is laid out), None where the face has no such
    view, and its length in words."""
    words: int
    per_class: int
    margin: int | None
    scratch: int | None
    escalate: int | None


@functools.lru_cache(maxsize=256)
def tiled_layout(b: int, c: int, *, margin: bool, scratch: int,
                 escalate: bool, pred: bool = True) -> TiledLayout:
    """pred (B,) int32 (not for B7a's raw counts: ``pred=False``),
    per_class (B, C) f32 (B7a's counts), margin (B,) f32, ``scratch`` words
    of cooperative scratch and escalate (B,) bytes, in that order: every
    view but escalate starts on a word."""
    per_class_at = 4 * b if pred else 0
    words = per_class_at // 4 + b * c
    margin_at = 4 * words if margin else None
    words += b if margin else 0
    scratch_at = 4 * words if scratch else None
    words += scratch
    escalate_at = 4 * words if escalate else None
    words += -(-b // 4) if escalate else 0
    return TiledLayout(words, per_class_at, margin_at, scratch_at,
                       escalate_at)


def tiled_design(rows: int, block: str | None = None) -> str:
    """The design of a tiled launch over ``rows`` template rows: ``block``
    where the caller names one ("local" or "cooperative"; another name
    raises), else local up to `LOCAL_ROWS` rows (read at each call) and
    cooperative past it."""
    if block is not None:
        return tuning.check_block("acam_match", block)
    return "local" if rows <= LOCAL_ROWS else "cooperative"


def _scratch(b: int, n: int, k: int, cp: int, c: int, *,
             raw: bool = False, design: str | None = None) -> int:
    """The tiled kernel's scratch words: none for the local design
    (``design``, else `tiled_design`'s), else the bits and, unless ``raw``
    (B7a, no decision), one arrival counter per row (at least one per query
    group) after the summaries."""
    if (design or tiled_design(k * c)) == "local":
        return 0
    if raw:
        return (b + k * cp) * -(-n // 32)
    return scratch_words(b, n, k, cp, c, b)


def _tiled_shape(features, templates, num_classes):
    """(device, B, N, K, Cp) of a tiled face's call on the card."""
    device = features.device
    if device.type != "cuda":
        raise ValueError(f"features on {device}: the kernels take CUDA or "
                         "CPU tensors")
    if features.dim() != 2:
        raise ValueError(f"features must be (B, N), got "
                         f"{tuple(features.shape)}")
    b, n = features.shape
    cp = layout.padded_classes(num_classes)
    rows = templates.numel() // max(n, 1)
    if n < 1 or rows % cp or rows == 0:
        raise ValueError(f"templates {tuple(templates.shape)} are not a "
                         f"K-major bank of {num_classes} classes over {n} "
                         "features")
    return device, b, n, rows // cp, cp


def _require(device: torch.device, operands) -> None:
    """One combined test per (name, tensor, dtype, shape); `_check` only
    to raise with the reason."""
    for name, x, dtype, shape in operands:
        if (x.dtype is not dtype or x.shape != shape or x.device != device
                or not x.is_contiguous()):
            _check(name, x, device, dtype, shape)


def _outputs(buf: torch.Tensor, lay: TiledLayout, b: int, c: int) -> tuple:
    """pred, per_class and (where laid out) margin and escalate as views of
    ``buf``; `as_strided` is the cheapest view to build."""
    fbuf = buf.view(torch.float32)
    out = (buf.as_strided((b,), (1,), 0),
           fbuf.as_strided((b, c), (c, 1), lay.per_class // 4))
    if lay.margin is not None:
        out += (fbuf.as_strided((b,), (1,), lay.margin // 4),)
    if lay.escalate is not None:
        out += (buf.view(torch.bool).as_strided((b,), (1,), lay.escalate),)
    return out


def acam_match_classify(features, thresholds, templates_kmajor, valid_row,
                        num_classes: int):
    """Fused Eq. 8 + Eq. 12 from raw features to the WTA (B1).

    features (B, N) f32, thresholds (N,), templates_kmajor (K * Cp, N)
    {0,1}, valid_row (K * Cp,) f32 {0,1}. Returns (pred (B,) int32,
    per_class (B, C) f32).
    """
    if features.device.type == "cpu":
        return classify_plain(features, thresholds, templates_kmajor,
                              valid_row, num_classes)
    device, b, n, k, cp = _tiled_shape(features, templates_kmajor,
                                       num_classes)
    f32 = torch.float32
    _require(device, (("features", features, f32, (b, n)),
                      ("thresholds", thresholds, f32, (n,)),
                      ("templates_kmajor", templates_kmajor, f32,
                       (k * cp, n)),
                      ("valid_row", valid_row, f32, (k * cp,))))
    lay = tiled_layout(b, num_classes, margin=False,
                       scratch=_scratch(b, n, k, cp, num_classes),
                       escalate=False)
    buf = torch.empty(lay.words, dtype=torch.int32, device=device)
    if b:
        base = buf.data_ptr()
        _launch("acam_match_classify", device, features.data_ptr(),
                thresholds.data_ptr(), templates_kmajor.data_ptr(),
                valid_row.data_ptr(), b, n, k, cp, num_classes,
                None if lay.scratch is None else base + lay.scratch, base,
                base + lay.per_class)
    return _outputs(buf, lay, b, num_classes)


def acam_match_classify_margins(features, thresholds, templates_kmajor,
                                valid_row, class_lo, class_hi,
                                num_classes: int):
    """B1 plus per-row class windows [class_lo, class_hi) and the Eq. 12
    winner-vs-runner-up margin clamped to N (B4). class_lo/hi (B,) int32.
    Returns (pred, per_class, margin (B,) f32)."""
    if features.device.type == "cpu":
        return classify_margins_plain(features, thresholds, templates_kmajor,
                                      valid_row, class_lo, class_hi,
                                      num_classes)
    device, b, n, k, cp = _tiled_shape(features, templates_kmajor,
                                       num_classes)
    f32, i32 = torch.float32, torch.int32
    _require(device, (("features", features, f32, (b, n)),
                      ("thresholds", thresholds, f32, (n,)),
                      ("templates_kmajor", templates_kmajor, f32,
                       (k * cp, n)),
                      ("valid_row", valid_row, f32, (k * cp,)),
                      ("class_lo", class_lo, i32, (b,)),
                      ("class_hi", class_hi, i32, (b,))))
    lay = tiled_layout(b, num_classes, margin=True,
                       scratch=_scratch(b, n, k, cp, num_classes),
                       escalate=False)
    buf = torch.empty(lay.words, dtype=i32, device=device)
    if b:
        base = buf.data_ptr()
        _launch("acam_match_classify_margins", device, features.data_ptr(),
                thresholds.data_ptr(), templates_kmajor.data_ptr(),
                valid_row.data_ptr(), class_lo.data_ptr(),
                class_hi.data_ptr(), b, n, k, cp, num_classes,
                None if lay.scratch is None else base + lay.scratch, base,
                base + lay.per_class, base + lay.margin)
    return _outputs(buf, lay, b, num_classes)


def acam_match(features, thresholds, templates, *, block=None,
               interpret: bool = False):
    """Raw Eq. 8 match counts (B7a): features (B, N) f32, thresholds (N,),
    templates (M, N) {0,1} -> (B, M) f32, every row counted (no valid
    mask). ``block`` names the tiled kernel's design ("local" or
    "cooperative"; another name raises); None takes the tuning table's
    (`tuning.get_block`). ``interpret`` is the Pallas argument, accepted
    for signature parity and ignored."""
    if block is not None:
        tuning.check_block("acam_match", block)
    if features.device.type == "cpu":
        return match_plain(features, thresholds, templates)
    device = features.device
    if device.type != "cuda":
        raise ValueError(f"features on {device}: the kernels take CUDA or "
                         "CPU tensors")
    if features.dim() != 2 or features.shape[1] < 1:
        raise ValueError(f"features must be (B, N) with N >= 1, got "
                         f"{tuple(features.shape)}")
    b, n = features.shape
    m = templates.shape[0]
    f32 = torch.float32
    _require(device, (("features", features, f32, (b, n)),
                      ("thresholds", thresholds, f32, (n,)),
                      ("templates", templates, f32, (m, n))))
    # one K = 1 slice of M classes, padded to whole class tiles only in the
    # kernel's bit scratch: the bank itself is read as it is
    cp = -(-m // CLASS_TILE) * CLASS_TILE
    design = tuning.resolve_block("acam_match", (b, m, n), f32, device,
                                  block)
    lay = tiled_layout(b, m, margin=False,
                       scratch=_scratch(b, n, 1, cp, m, raw=True,
                                        design=design),
                       escalate=False, pred=False)
    buf = torch.empty(lay.words, dtype=f32, device=device)
    if b and m:
        base = buf.data_ptr()
        _launch("acam_match", device, features.data_ptr(),
                thresholds.data_ptr(), templates.data_ptr(), b, n, m,
                None if lay.scratch is None else base + lay.scratch, base)
    return buf.as_strided((b, m), (m, 1), 0)


def acam_match_classify_margins_chunked(features, thresholds, templates_kcp,
                                        valid_kcp, class_lo, class_hi,
                                        num_classes: int, *, chunk: int):
    """B4 over a (K, Cp, N) stack, the big-bank face (B2). ``chunk`` must
    divide Cp; the outputs do not depend on it."""
    if features.device.type == "cpu":
        return classify_margins_chunked_plain(
            features, thresholds, templates_kcp, valid_kcp, class_lo,
            class_hi, num_classes, chunk=chunk)
    device, b, n, k, cp = _tiled_shape(features, templates_kcp, num_classes)
    _check_chunk(cp, chunk)
    f32, i32 = torch.float32, torch.int32
    _require(device, (("features", features, f32, (b, n)),
                      ("thresholds", thresholds, f32, (n,)),
                      ("templates_kcp", templates_kcp, f32, (k, cp, n)),
                      ("valid_kcp", valid_kcp, f32, (k, cp)),
                      ("class_lo", class_lo, i32, (b,)),
                      ("class_hi", class_hi, i32, (b,))))
    lay = tiled_layout(b, num_classes, margin=True,
                       scratch=b2_scratch_words(b, n, k, cp, num_classes),
                       escalate=False)
    buf = torch.empty(lay.words, dtype=i32, device=device)
    if b:
        base = buf.data_ptr()
        _launch("acam_match_classify_margins_chunked", device,
                features.data_ptr(), thresholds.data_ptr(),
                templates_kcp.data_ptr(), valid_kcp.data_ptr(),
                class_lo.data_ptr(), class_hi.data_ptr(), b, n, k, cp,
                num_classes, chunk, base + lay.scratch, base,
                base + lay.per_class, base + lay.margin)
    return _outputs(buf, lay, b, num_classes)


def acam_match_serve(features, thr_table, tenant_slot, templates_kcp,
                     valid_kcp, class_lo, class_hi, tau, num_classes: int, *,
                     chunk: int):
    """The serving tick (B3): per-slot threshold-row gather -> (f - thr) > 0
    -> match -> per-class max -> windowed margin -> escalate = margin < tau.

    features (B, N) f32 raw, thr_table (T, N) f32, tenant_slot (B,) int32,
    templates_kcp (K, Cp, N), valid_kcp (K, Cp), class_lo/hi (B,) int32,
    tau (B,) f32. A slot outside [0, T) reads zero thresholds. Returns
    (pred, per_class, margin, escalate (B,) bool).
    """
    if features.device.type == "cpu":
        return serve_plain(features, thr_table, tenant_slot, templates_kcp,
                           valid_kcp, class_lo, class_hi, tau, num_classes,
                           chunk=chunk)
    device, b, n, k, cp = _tiled_shape(features, templates_kcp, num_classes)
    _check_chunk(cp, chunk)
    f32, i32 = torch.float32, torch.int32
    t_rows = thr_table.shape[0] if thr_table.dim() == 2 else -1
    _require(device, (("features", features, f32, (b, n)),
                      ("thr_table", thr_table, f32, (t_rows, n)),
                      ("tenant_slot", tenant_slot, i32, (b,)),
                      ("templates_kcp", templates_kcp, f32, (k, cp, n)),
                      ("valid_kcp", valid_kcp, f32, (k, cp)),
                      ("class_lo", class_lo, i32, (b,)),
                      ("class_hi", class_hi, i32, (b,)),
                      ("tau", tau, f32, (b,))))
    lay = tiled_layout(b, num_classes, margin=True,
                       scratch=_scratch(b, n, k, cp, num_classes),
                       escalate=True)
    buf = torch.empty(lay.words, dtype=i32, device=device)
    if b:
        base = buf.data_ptr()
        _launch("acam_match_serve", device, features.data_ptr(),
                thr_table.data_ptr(), t_rows, tenant_slot.data_ptr(),
                templates_kcp.data_ptr(), valid_kcp.data_ptr(),
                class_lo.data_ptr(), class_hi.data_ptr(), tau.data_ptr(), b,
                n, k, cp, num_classes, chunk,
                None if lay.scratch is None else base + lay.scratch, base,
                base + lay.per_class, base + lay.margin,
                base + lay.escalate)
    return _outputs(buf, lay, b, num_classes)
