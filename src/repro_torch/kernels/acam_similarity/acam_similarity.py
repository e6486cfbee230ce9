"""ACAM similarity kernels (paper Eq. 9-11 + Eq. 12), three faces.

Each face keeps the signature of its Pallas TPU counterpart in
`repro/kernels/acam_similarity/acam_similarity.py` (raw ``(M, N)`` windows,
K-major ``(K * Cp, N)`` or ``(K, Cp, N)`` window stacks, ``num_classes``,
``alpha``, ``chunk``) and comes in two versions in this module:

  * a **plain PyTorch** version (``*_plain``): binarise, Eq. 9-11 in the
    arithmetic order of `ref` (hit count, ``* inv_n``, ``/ (1 + alpha *
    D)``), the valid mask, the per-class max over K, and the `layout`
    epilogues (margin cap 1.0);
  * a **CUDA wrapper** (the un-suffixed name) over `csrc/acam_similarity.cu`.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Each launch adds one to its face's
entry in `LAUNCHES`. ``block`` names a design: B7b's tiling ("narrow" or
"wide"; None takes the tuning table's, `repro_torch.kernels.tuning`), B5's
and B6's tiled design ("local" or "cooperative"; None the `LOCAL_ROWS`
rule); another name raises. ``interpret`` is the Pallas argument, accepted
for signature parity and ignored.

    face                      TPU kernel replaced (acam_similarity.py)
    acam_similarity           _kernel                                 B7b
    acam_similarity_classify  _classify_kernel                        B5
    acam_similarity_serve     _serve_kernel                           B6

B5 and B6 are one launch each of the feature-count faces' tiled kernel
(`csrc/acam_tiled.cuh`) with its similarity scorer: binarised queries
against two bit planes of each window row, exact hit counts by popc, and
D = N - H on binary windows (a float sum of D on other rows). They share
the feature-count faces' design choice (`acam_match.LOCAL_ROWS`: local for
predict's small bank, cooperative past it), their one allocation per call
(`acam_match.tiled_layout`, with `scratch_words` here) and their output
views. B7b scores raw queries in its own kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, layout, tuning
from repro_torch.kernels.acam_match import acam_match as am
from repro_torch.kernels.acam_match.acam_match import (_check, _check_chunk,
                                                       _slot_thresholds)
from repro_torch.kernels.acam_similarity.ref import (acam_similarity_ref,
                                                     inv_n)

#: kernel launches per face since the last `reset_launches()`
LAUNCHES = {"acam_similarity": 0, "acam_similarity_classify": 0,
            "acam_similarity_serve": 0}

#: the similarity margin is clamped to the score range [0, 1]
MARGIN_CAP = 1.0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

def similarity_plain(queries, lower, upper, *, alpha=1.0):
    return acam_similarity_ref(queries, lower, upper, alpha=alpha)


def _per_class(q, lower_km, upper_km, valid_row, num_classes, alpha):
    """(per_class (B, Cp), pred) of binary queries against a K-major bank."""
    cp = layout.padded_classes(num_classes)
    s = acam_similarity_ref(q, lower_km, upper_km, alpha=alpha)
    return layout.wta_epilogue(s, valid_row[None, :], cp,
                               lower_km.shape[0] // cp)


def classify_plain(features, thresholds, lower_kmajor, upper_kmajor,
                   valid_row, num_classes, *, alpha=1.0):
    per_class, pred = _per_class(
        (features > thresholds).to(torch.float32), lower_kmajor,
        upper_kmajor, valid_row, num_classes, alpha)
    return pred, per_class[:, :num_classes]


def serve_plain(features, thr_table, tenant_slot, lower_kcp, upper_kcp,
                valid_kcp, class_lo, class_hi, tau, num_classes, *,
                alpha=1.0, chunk):
    _check_chunk(lower_kcp.shape[1], chunk)
    n = features.shape[-1]
    q = ((features - _slot_thresholds(thr_table, tenant_slot)) > 0).to(
        torch.float32)
    per_class, _ = _per_class(q, lower_kcp.reshape(-1, n),
                              upper_kcp.reshape(-1, n),
                              valid_kcp.reshape(-1), num_classes, alpha)
    pred, margin = layout.windowed_margin(
        per_class, class_lo.to(torch.int32)[:, None],
        class_hi.to(torch.int32)[:, None], MARGIN_CAP)
    return pred, per_class[:, :num_classes], margin, margin < tau


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, lower, upper, B, M, N, alpha, inv_n, tiling, scores, stream
    "acam_similarity": [_P] * 3 + [_I] * 3 + [_F] * 2 + [_I] + [_P] * 2,
    # f, thr, lower, upper, valid, B, N, K, Cp, C, alpha, inv_n, scratch,
    # pred, per_class, stream
    "acam_similarity_classify": [_P] * 5 + [_I] * 5 + [_F] * 2 + [_P] * 4,
    # f, thr_table, thr_rows, slot, lower, upper, valid, lo, hi, tau, B, N,
    # K, Cp, C, chunk, alpha, inv_n, scratch, pred, per_class, margin, esc,
    # stream
    "acam_similarity_serve": [_P, _P, _I] + [_P] * 7 + [_I] * 6 + [_F] * 2
    + [_P] * 6,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("acam_similarity", _SIGNATURES)


def _run(name: str, device: torch.device, *args) -> None:
    """Call face ``name`` (pointers, ints and f32 floats) on ``device``'s
    current stream; raise on a CUDA error."""
    _build.launch(_lib(), name, device, LAUNCHES, *args)


def _cuda_operands(features, lower, upper):
    """Validate the query and window operands of a B7b launch."""
    device = features.device
    if device.type != "cuda":
        raise ValueError(f"features on {device}: the kernels take CUDA or "
                         "CPU tensors")
    if features.dim() != 2 or features.shape[1] < 1:
        raise ValueError(f"features must be (B, N) with N >= 1, got "
                         f"{tuple(features.shape)}")
    b, n = features.shape
    _check("features", features, device, torch.float32, (b, n))
    _check("lower", lower, device, torch.float32, tuple(lower.shape))
    _check("upper", upper, device, torch.float32, tuple(lower.shape))
    if lower.shape[-1] != n:
        raise ValueError(f"windows {tuple(lower.shape)} do not match {n} "
                         "features")
    return device, b, n


def scratch_words(b: int, n: int, k: int, cp: int, c: int,
                  design: str | None = None) -> int:
    """int32 words of B5's and B6's tiled scratch: none in the local design
    (``design``, else `acam_match.tiled_design`'s), else the feature
    count's (query bits, one template plane, summaries, B arrival counters)
    plus the second plane (K * Cp rows of W words), one binary flag per
    template row and one f32 distance per (query, template row)."""
    if am.tiled_design(k * c, design) == "local":
        return 0
    return (am.scratch_words(b, n, k, cp, c, b)
            + k * cp * (-(-n // 32) + 1 + b))


def acam_similarity(queries, lower, upper, *, alpha: float = 1.0,
                    block=None, interpret: bool = False):
    """Eq. 9-11 scores (B, M) of raw queries (B, N) against windows (M, N)
    with lower <= upper (B7b), in the tiling ``block`` names ("narrow" or
    "wide"), else the tuning table's."""
    if block is not None:
        tuning.check_block("acam_similarity", block)
    if queries.device.type == "cpu":
        return similarity_plain(queries, lower, upper, alpha=alpha)
    device, b, n = _cuda_operands(queries, lower, upper)
    m = lower.shape[0]
    _check("lower", lower, device, torch.float32, (m, n))
    tiling = tuning.resolve_block("acam_similarity", (b, m, n),
                                  torch.float32, device, block)
    out = torch.empty((b, m), dtype=torch.float32, device=device)
    if b and m:
        _run("acam_similarity", device, queries.data_ptr(),
             lower.data_ptr(), upper.data_ptr(), b, m, n, alpha, inv_n(n),
             tuning.BLOCKS["acam_similarity"].index(tiling), out.data_ptr())
    return out


def acam_similarity_classify(features, thresholds, lower_kmajor,
                             upper_kmajor, valid_row, num_classes: int, *,
                             alpha: float = 1.0, block=None,
                             interpret: bool = False):
    """Fused Eq. 9-12 from raw features to the WTA (B5).

    features (B, N) f32, thresholds (N,), lower/upper_kmajor (K * Cp, N),
    valid_row (K * Cp,) f32 {0,1}. Returns (pred (B,) int32, per_class
    (B, C) f32).
    """
    if block is not None:
        am.tiled_design(0, block)
    if features.device.type == "cpu":
        return classify_plain(features, thresholds, lower_kmajor,
                              upper_kmajor, valid_row, num_classes,
                              alpha=alpha)
    device, b, n, k, cp = am._tiled_shape(features, lower_kmajor,
                                          num_classes)
    f32 = torch.float32
    am._require(device, (("features", features, f32, (b, n)),
                         ("thresholds", thresholds, f32, (n,)),
                         ("lower_kmajor", lower_kmajor, f32, (k * cp, n)),
                         ("upper_kmajor", upper_kmajor, f32, (k * cp, n)),
                         ("valid_row", valid_row, f32, (k * cp,))))
    lay = am.tiled_layout(b, num_classes, margin=False,
                          scratch=scratch_words(b, n, k, cp, num_classes,
                                                block),
                          escalate=False)
    buf = torch.empty(lay.words, dtype=torch.int32, device=device)
    if b:
        base = buf.data_ptr()
        _run("acam_similarity_classify", device, features.data_ptr(),
             thresholds.data_ptr(), lower_kmajor.data_ptr(),
             upper_kmajor.data_ptr(), valid_row.data_ptr(), b, n, k, cp,
             num_classes, alpha, inv_n(n),
             None if lay.scratch is None else base + lay.scratch, base,
             base + lay.per_class)
    return am._outputs(buf, lay, b, num_classes)


def acam_similarity_serve(features, thr_table, tenant_slot, lower_kcp,
                          upper_kcp, valid_kcp, class_lo, class_hi, tau,
                          num_classes: int, *, alpha: float = 1.0,
                          chunk: int, block=None, interpret: bool = False):
    """The similarity serving tick (B6): per-slot threshold-row gather ->
    (f - thr) > 0 -> Eq. 9-11 -> per-class max -> windowed margin (cap
    1.0) -> escalate = margin < tau.

    features (B, N) f32 raw, thr_table (T, N) f32, tenant_slot (B,) int32,
    lower/upper_kcp (K, Cp, N), valid_kcp (K, Cp), class_lo/hi (B,) int32,
    tau (B,) f32. ``chunk`` must divide Cp; the outputs do not depend on it.
    Returns (pred, per_class, margin, escalate (B,) bool).
    """
    if block is not None:
        am.tiled_design(0, block)
    if features.device.type == "cpu":
        return serve_plain(features, thr_table, tenant_slot, lower_kcp,
                           upper_kcp, valid_kcp, class_lo, class_hi, tau,
                           num_classes, alpha=alpha, chunk=chunk)
    device, b, n, k, cp = am._tiled_shape(features, lower_kcp, num_classes)
    _check_chunk(cp, chunk)
    f32, i32 = torch.float32, torch.int32
    t_rows = thr_table.shape[0] if thr_table.dim() == 2 else -1
    am._require(device, (("features", features, f32, (b, n)),
                         ("thr_table", thr_table, f32, (t_rows, n)),
                         ("tenant_slot", tenant_slot, i32, (b,)),
                         ("lower_kcp", lower_kcp, f32, (k, cp, n)),
                         ("upper_kcp", upper_kcp, f32, (k, cp, n)),
                         ("valid_kcp", valid_kcp, f32, (k, cp)),
                         ("class_lo", class_lo, i32, (b,)),
                         ("class_hi", class_hi, i32, (b,)),
                         ("tau", tau, f32, (b,))))
    lay = am.tiled_layout(b, num_classes, margin=True,
                          scratch=scratch_words(b, n, k, cp, num_classes,
                                                block),
                          escalate=True)
    buf = torch.empty(lay.words, dtype=i32, device=device)
    if b:
        base = buf.data_ptr()
        _run("acam_similarity_serve", device, features.data_ptr(),
             thr_table.data_ptr(), t_rows, tenant_slot.data_ptr(),
             lower_kcp.data_ptr(), upper_kcp.data_ptr(), valid_kcp.data_ptr(),
             class_lo.data_ptr(), class_hi.data_ptr(), tau.data_ptr(), b, n,
             k, cp, num_classes, chunk, alpha, inv_n(n),
             None if lay.scratch is None else base + lay.scratch, base,
             base + lay.per_class, base + lay.margin, base + lay.escalate)
    return am._outputs(buf, lay, b, num_classes)
