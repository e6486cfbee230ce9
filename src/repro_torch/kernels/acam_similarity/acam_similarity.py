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
entry in `LAUNCHES`. ``block`` and ``interpret`` are the Pallas tiling
arguments, accepted for signature parity and ignored.

    face                      TPU kernel replaced (acam_similarity.py)
    acam_similarity           _kernel                                 B7b
    acam_similarity_classify  _classify_kernel                        B5
    acam_similarity_serve     _serve_kernel                           B6
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, layout
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
    # q, lower, upper, B, M, N, alpha, inv_n, scores, stream
    "acam_similarity": [_P] * 3 + [_I] * 3 + [_F] * 2 + [_P] * 2,
    # f, thr, lower, upper, valid, B, N, K, Cp, C, alpha, inv_n, pred,
    # per_class, stream
    "acam_similarity_classify": [_P] * 5 + [_I] * 5 + [_F] * 2 + [_P] * 3,
    # f, thr_table, thr_rows, slot, lower, upper, valid, lo, hi, tau, B, N,
    # K, Cp, C, chunk, alpha, inv_n, pred, per_class, margin, esc, stream
    "acam_similarity_serve": [_P, _P, _I] + [_P] * 7 + [_I] * 6 + [_F] * 2
    + [_P] * 5,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("acam_similarity", _SIGNATURES)


def _run(name: str, device: torch.device, *args) -> None:
    """Launch a face on ``device``'s current stream (tensors pass as their
    device pointers, floats as f32); raise on a CUDA error."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = getattr(_lib(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1


def _cuda_operands(features, lower, upper):
    """Validate the query and window operands of a CUDA launch."""
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


def _bank_shape(lower, n: int, num_classes: int) -> tuple[int, int]:
    """(K, Cp) of a K-major window bank of ``num_classes`` classes."""
    cp = layout.padded_classes(num_classes)
    rows = lower.numel() // n
    if rows % cp or rows == 0:
        raise ValueError(f"windows {tuple(lower.shape)} are not a K-major "
                         f"bank of {num_classes} classes over {n} features")
    return rows // cp, cp


def acam_similarity(queries, lower, upper, *, alpha: float = 1.0,
                    block=None, interpret: bool = False):
    """Eq. 9-11 scores (B, M) of raw queries (B, N) against windows (M, N)
    with lower <= upper (B7b)."""
    if queries.device.type == "cpu":
        return similarity_plain(queries, lower, upper, alpha=alpha)
    device, b, n = _cuda_operands(queries, lower, upper)
    m = lower.shape[0]
    _check("lower", lower, device, torch.float32, (m, n))
    out = torch.empty((b, m), dtype=torch.float32, device=device)
    if b and m:
        _run("acam_similarity", device, queries, lower, upper, b, m, n,
             alpha, inv_n(n), out)
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
    if features.device.type == "cpu":
        return classify_plain(features, thresholds, lower_kmajor,
                              upper_kmajor, valid_row, num_classes,
                              alpha=alpha)
    device, b, n = _cuda_operands(features, lower_kmajor, upper_kmajor)
    k, cp = _bank_shape(lower_kmajor, n, num_classes)
    _check("thresholds", thresholds, device, torch.float32, (n,))
    _check("lower_kmajor", lower_kmajor, device, torch.float32, (k * cp, n))
    _check("valid_row", valid_row, device, torch.float32, (k * cp,))
    pred = torch.empty(b, dtype=torch.int32, device=device)
    per_class = torch.empty((b, num_classes), dtype=torch.float32,
                            device=device)
    if b:
        _run("acam_similarity_classify", device, features, thresholds,
             lower_kmajor, upper_kmajor, valid_row, b, n, k, cp, num_classes,
             alpha, inv_n(n), pred, per_class)
    return pred, per_class


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
    if features.device.type == "cpu":
        return serve_plain(features, thr_table, tenant_slot, lower_kcp,
                           upper_kcp, valid_kcp, class_lo, class_hi, tau,
                           num_classes, alpha=alpha, chunk=chunk)
    device, b, n = _cuda_operands(features, lower_kcp, upper_kcp)
    k, cp = _bank_shape(lower_kcp, n, num_classes)
    _check_chunk(cp, chunk)
    t_rows = thr_table.shape[0] if thr_table.dim() == 2 else -1
    _check("thr_table", thr_table, device, torch.float32, (t_rows, n))
    _check("tenant_slot", tenant_slot, device, torch.int32, (b,))
    _check("lower_kcp", lower_kcp, device, torch.float32, (k, cp, n))
    _check("valid_kcp", valid_kcp, device, torch.float32, (k, cp))
    _check("class_lo", class_lo, device, torch.int32, (b,))
    _check("class_hi", class_hi, device, torch.int32, (b,))
    _check("tau", tau, device, torch.float32, (b,))
    pred = torch.empty(b, dtype=torch.int32, device=device)
    per_class = torch.empty((b, num_classes), dtype=torch.float32,
                            device=device)
    margin = torch.empty(b, dtype=torch.float32, device=device)
    esc = torch.empty(b, dtype=torch.bool, device=device)
    if b:
        _run("acam_similarity_serve", device, features, thr_table, t_rows,
             tenant_slot, lower_kcp, upper_kcp, valid_kcp, class_lo,
             class_hi, tau, b, n, k, cp, num_classes, chunk, alpha, inv_n(n),
             pred, per_class, margin, esc)
    return pred, per_class, margin, esc
