"""Public wrappers over the acam_similarity kernels: class-major
``(C, K, N)`` window banks in, the kernels' K-major layouts built here.

`similarity_scores` runs the raw-score kernel (B7b); `classify` adds the
Eq. 12 epilogue in PyTorch (the two-stage path); `classify_fused` is the
single-launch binarise -> window match -> WTA path (B5); `serve_classify`
is the multi-tenant serving tick (B6); `classify_fused_margins` is B6 with
one shared thresholds row and tau -inf, at any bank size. ``block`` names
a design: B7b's tiling ("narrow" or "wide"; None takes the tuning table's,
`repro_torch.kernels.tuning`) for the raw scores, the tiled kernel's
("local" or "cooperative"; None the `acam_match.LOCAL_ROWS` rule) for B5
and B6; another name raises.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import layout
from repro_torch.kernels.acam_match.ops import (LAYOUT_SPAN, _f32, _i32,
                                                _windows)
from repro_torch.kernels.acam_similarity.acam_similarity import (
    acam_similarity, acam_similarity_classify, acam_similarity_serve)


def similarity_scores(queries, lower, upper, *, alpha: float = 1.0,
                      block=None):
    """(B, M) Eq. 11 scores of raw queries against (M, N) windows."""
    return acam_similarity(_f32(queries), _f32(lower), _f32(upper),
                           alpha=alpha, block=block)


def classify(queries, lower_flat, upper_flat, valid_flat, num_classes: int,
             *, alpha: float = 1.0, block=None):
    """Eq. 12 decision over a class-major flattened (C * K, N) window bank:
    the raw-score kernel, then the valid mask, the max over K and the WTA.
    Returns (pred (B,) int32, per_class (B, C))."""
    s = similarity_scores(queries, lower_flat, upper_flat, alpha=alpha,
                          block=block)
    s = torch.where(valid_flat[None, :].to(torch.bool), s,
                    torch.tensor(float("-inf"), device=s.device))
    k = lower_flat.shape[0] // num_classes
    per_class = s.reshape(s.shape[0], num_classes, k).amax(dim=-1)
    return torch.argmax(per_class, dim=-1).to(torch.int32), per_class


def classify_fused(features, thresholds, lower_ck, upper_ck, valid_ck, *,
                   alpha: float = 1.0, block=None):
    """Single-launch Eq. 9-12 over a (C, K, N) window bank.
    Returns (pred (B,) int32, per_class (B, C))."""
    c = lower_ck.shape[0]
    with obs.span(LAYOUT_SPAN):
        lower = _f32(layout.flatten_kmajor(lower_ck, c))
        upper = _f32(layout.flatten_kmajor(upper_ck, c))
        valid = layout.valid_kmajor(valid_ck, c)
    return acam_similarity_classify(
        _f32(features), _f32(thresholds), lower, upper, valid, c,
        alpha=alpha, block=block)


def serve_classify(features, thr_table, tenant_slot, lower_ck, upper_ck,
                   valid_ck, class_lo=None, class_hi=None, tau=None, *,
                   alpha: float = 1.0, max_rows: int, block=None):
    """The multi-tenant serving tick in one kernel call, with Eq. 9-11
    scoring: per-slot threshold gather, binarisation, window match,
    per-class max, windowed margin (cap 1.0) and the cascade's ``margin <
    tau`` bit. ``tau`` defaults to -inf (never escalate); windows default to
    the whole bank."""
    c, k, _ = lower_ck.shape
    b = features.shape[0]
    lo, hi = _windows(b, c, features.device, class_lo, class_hi)
    if tau is None:
        tau = torch.full((b,), float("-inf"), device=features.device)
    chunk = layout.class_chunk(layout.padded_classes(c), k, max_rows)
    with obs.span(LAYOUT_SPAN):
        lower = _f32(layout.stack_kcp(lower_ck, c))
        upper = _f32(layout.stack_kcp(upper_ck, c))
        valid = layout.valid_kcp(valid_ck, c)
    return acam_similarity_serve(
        _f32(features), _f32(thr_table), _i32(tenant_slot), lower, upper,
        valid, lo, hi, _f32(tau), c, alpha=alpha, chunk=chunk, block=block)


def classify_fused_margins(features, thresholds, lower_ck, upper_ck,
                           valid_ck, class_lo=None, class_hi=None, *,
                           alpha: float = 1.0, max_rows: int, block=None):
    """Single-launch Eq. 9-12 + windowed margin at any bank size: the serve
    kernel with ONE shared thresholds row (every query binarises against
    it) and tau -inf, the escalation bit dropped. Returns (pred, per_class,
    margin)."""
    b = features.shape[0]
    pred, per_class, margin, _ = serve_classify(
        features, thresholds[None, :],
        torch.zeros((b,), dtype=torch.int32, device=features.device),
        lower_ck, upper_ck, valid_ck, class_lo, class_hi, None, alpha=alpha,
        max_rows=max_rows, block=block)
    return pred, per_class, margin
