"""Public wrappers over the acam_match kernels: class-major ``(C, K, N)``
banks in, the kernels' K-major layouts built here.

`classify_fused` is the single-launch binarise -> match -> WTA path;
`classify_fused_margins` adds per-row class windows and the Eq. 12 margin;
`classify_fused_margins_chunked` is the same for banks past the fused-row
budget; `serve_classify` is the multi-tenant serving tick.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import layout
from repro_torch.kernels.acam_match.acam_match import (
    acam_match_classify, acam_match_classify_margins,
    acam_match_classify_margins_chunked, acam_match_serve)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def _windows(b: int, c: int, device, class_lo, class_hi):
    if class_lo is None:
        class_lo = torch.zeros((b,), dtype=torch.int32, device=device)
    if class_hi is None:
        class_hi = torch.full((b,), c, dtype=torch.int32, device=device)
    return _i32(class_lo), _i32(class_hi)


def classify_fused(features, thresholds, templates_ck, valid_ck):
    """Single-launch Eq. 8 + Eq. 12 over a (C, K, N) bank.
    Returns (pred (B,) int32, per_class (B, C))."""
    c = templates_ck.shape[0]
    return acam_match_classify(_f32(features), _f32(thresholds),
                               _f32(layout.flatten_kmajor(templates_ck, c)),
                               layout.valid_kmajor(valid_ck, c), c)


def classify_fused_margins(features, thresholds, templates_ck, valid_ck,
                           class_lo=None, class_hi=None):
    """`classify_fused` + windows ``[class_lo, class_hi)`` (default: the
    whole bank) -> (pred, per_class, margin)."""
    c = templates_ck.shape[0]
    lo, hi = _windows(features.shape[0], c, features.device, class_lo,
                      class_hi)
    return acam_match_classify_margins(
        _f32(features), _f32(thresholds),
        _f32(layout.flatten_kmajor(templates_ck, c)),
        layout.valid_kmajor(valid_ck, c), lo, hi, c)


def classify_fused_margins_chunked(features, thresholds, templates_ck,
                                   valid_ck, class_lo=None, class_hi=None, *,
                                   max_rows: int):
    """`classify_fused_margins` for banks past ``max_rows`` fused rows: the
    (K, Cp, N) stack with `layout.class_chunk` columns per chunk."""
    c, k, _ = templates_ck.shape
    lo, hi = _windows(features.shape[0], c, features.device, class_lo,
                      class_hi)
    chunk = layout.class_chunk(layout.padded_classes(c), k, max_rows)
    return acam_match_classify_margins_chunked(
        _f32(features), _f32(thresholds),
        _f32(layout.stack_kcp(templates_ck, c)),
        layout.valid_kcp(valid_ck, c), lo, hi, c, chunk=chunk)


def serve_classify(features, thr_table, tenant_slot, templates_ck, valid_ck,
                   class_lo=None, class_hi=None, tau=None, *, max_rows: int):
    """The multi-tenant serving tick in one kernel call: per-slot threshold
    gather, binarisation, match, per-class max, windowed margin and the
    cascade's ``margin < tau`` bit. ``tau`` defaults to -inf (never
    escalate); windows default to the whole bank."""
    c, k, _ = templates_ck.shape
    b = features.shape[0]
    lo, hi = _windows(b, c, features.device, class_lo, class_hi)
    if tau is None:
        tau = torch.full((b,), float("-inf"), device=features.device)
    chunk = layout.class_chunk(layout.padded_classes(c), k, max_rows)
    return acam_match_serve(
        _f32(features), _f32(thr_table), _i32(tenant_slot),
        _f32(layout.stack_kcp(templates_ck, c)),
        layout.valid_kcp(valid_ck, c), lo, hi, _f32(tau), c, chunk=chunk)
