"""Matching backends: the implementations of Eq. 8-12 behind `MatchEngine`.

Every backend implements the same entry points over a `TemplateBank`:

  classify(queries, bank)              binary queries        -> (pred, per_class)
  classify_features(features, bank)    raw features          -> (pred, per_class)
  classify_features_margin(features, bank, lo, hi)           -> (pred, per_class, margin)
  classify_serve(features, thr_table, slot, bank, lo, hi, tau)
                                       multi-tenant tick     -> (pred, per_class, margin, escalate)

Backends:

  reference  plain PyTorch oracles (both methods) — the parity baseline.
  kernel     the hand-written CUDA kernels of `repro_torch.kernels.
             acam_match` for the feature-count method, dispatched exactly as
             the JAX package's Pallas paths are: one kernel call per entry
             point, the K-major fused layout up to `MAX_FUSED_ROWS` rows and
             the (K, Cp, N) stack past it; the serving tick is one call of
             `acam_match_serve` (or the "compose" baseline). On CPU tensors
             each kernel runs its plain version.

The similarity kernels, the raw-score kernels behind the ``*_scores``
entry points and the device-physics backend come with later slices of the
port; the kernel backend raises `NotImplementedError` for them.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import quant
from repro_torch.core.templates import TemplateBank
from repro_torch.match.config import EngineConfig

NEG = float("-inf")

# The three constants below are the JAX package's, copied for API parity.
# They are NOT numbers of the card: the two crossovers were measured with
# Pallas in interpret mode on a CPU, and the row budget is a TPU VMEM
# policy. On CUDA "auto" always picks the kernel backend. Re-deriving them
# on the card is later work.

#: "auto" reference/kernel crossover (B * C * K * N cell matches) on a CPU
TINY_ELEMENTS = 32768

#: the similarity method's crossover: TINY_ELEMENTS * 16
TINY_ELEMENTS_SIMILARITY = 524288

#: fused layout up to this many K * Cp template rows, chunked stack past it
MAX_FUSED_ROWS = 2048


def tiny_cutoff(method: str) -> int:
    """Per-method "auto" dispatch cutoff in B * C * K * N cell matches."""
    return TINY_ELEMENTS_SIMILARITY if method == "similarity" \
        else TINY_ELEMENTS


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with a "
                               "later slice of the port (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# Shared epilogues and references (plain PyTorch)
# ---------------------------------------------------------------------------

def classify_scores(scores: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 12 with multi-template max-pooling: (B, C, K) -> (pred, per_class)."""
    per_class = scores.amax(dim=-1)
    return torch.argmax(per_class, dim=-1).to(torch.int32), per_class


def window_margin(per_class: torch.Tensor, class_lo=None, class_hi=None, *,
                  cap: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 12 decision + margin inside class windows (default: all classes).
    Returns (pred (B,) int32, margin (B,) f32 clamped to cap)."""
    from repro_torch.kernels.layout import windowed_margin

    b, c = per_class.shape
    dev = per_class.device
    if class_lo is None:
        class_lo = torch.zeros((b,), dtype=torch.int32, device=dev)
    if class_hi is None:
        class_hi = torch.full((b,), c, dtype=torch.int32, device=dev)
    return windowed_margin(per_class, class_lo.to(torch.int32)[:, None],
                           class_hi.to(torch.int32)[:, None], cap)


def feature_count_scores_ref(queries, templates, valid=None):
    """Eq. 8 reference: materialises the (B, C, K, N) comparison."""
    eq = queries[:, None, None, :] == templates[None, :, :, :]
    scores = eq.sum(dim=-1).to(torch.float32)
    if valid is not None:
        scores = torch.where(valid[None, :, :], scores,
                             torch.tensor(NEG, device=scores.device))
    return scores


def similarity_scores_ref(queries, lower, upper, valid=None, *,
                          alpha: float = 1.0):
    """Eq. 9-11 reference: materialises the (B, C, K, N) intermediate."""
    q = queries[:, None, None, :]
    lo = lower[None]
    hi = upper[None]
    above = torch.clamp(q - hi, min=0.0)
    below = torch.clamp(lo - q, min=0.0)
    d = (above**2 + below**2).sum(dim=-1)  # Eq. 9
    hit = ((q >= lo) & (q <= hi)).to(torch.float32).mean(dim=-1)  # Eq. 10
    s = hit / (1.0 + alpha * d)  # Eq. 11
    if valid is not None:
        s = torch.where(valid[None, :, :], s,
                        torch.tensor(NEG, device=s.device))
    return s


# ---------------------------------------------------------------------------
# Backend protocol
# ---------------------------------------------------------------------------

class MatchBackend:
    """Base class: the defaults compose the score entry points with the
    shared epilogues; subclasses override the paths they can fuse."""

    name = "base"

    def __init__(self, config: EngineConfig):
        self.config = config

    def feature_count_scores(self, queries, templates, valid=None):
        raise NotImplementedError

    def similarity_scores(self, queries, lower, upper, valid=None, *,
                          alpha=1.0):
        raise NotImplementedError

    def scores(self, queries, bank: TemplateBank) -> torch.Tensor:
        if self.config.method == "feature_count":
            return self.feature_count_scores(queries, bank.templates,
                                             bank.valid)
        return self.similarity_scores(queries, bank.lower, bank.upper,
                                      bank.valid, alpha=self.config.alpha)

    def classify(self, queries, bank: TemplateBank):
        """Eq. 8/11 + Eq. 12 over *binary* queries."""
        return classify_scores(self.scores(queries, bank))

    def classify_features(self, features, bank: TemplateBank):
        """Raw front-end features -> binarise -> match -> WTA (Fig. 2)."""
        return self.classify(quant.binarize(features, bank.thresholds), bank)

    def margin_cap(self, num_features: int) -> float:
        """Score range the margin is clamped to (empty-runner-up guard)."""
        return (float(num_features) if self.config.method == "feature_count"
                else 1.0)

    def classify_features_margin(self, features, bank: TemplateBank,
                                 class_lo=None, class_hi=None):
        _, per_class = self.classify_features(features, bank)
        pred, margin = window_margin(per_class, class_lo, class_hi,
                                     cap=self.margin_cap(features.shape[-1]))
        return pred, per_class, margin

    def classify_serve(self, features, thr_table, tenant_slot,
                       bank: TemplateBank, class_lo, class_hi, tau):
        """The multi-tenant tick, composed: gather each row's tenant
        threshold row, shift (binarize(f, thr) == binarize(f - thr, 0);
        the super-bank's own thresholds are zeros), classify with margins,
        compare with tau. -> (pred, per_class, margin, escalate (B,) bool)."""
        thr_rows = thr_table[tenant_slot.to(torch.int64)]
        pred, per_class, margin = self.classify_features_margin(
            features - thr_rows, bank, class_lo, class_hi)
        return pred, per_class, margin, margin < tau


class ReferenceBackend(MatchBackend):
    name = "reference"

    def feature_count_scores(self, queries, templates, valid=None):
        return feature_count_scores_ref(queries, templates, valid)

    def similarity_scores(self, queries, lower, upper, valid=None, *,
                          alpha=1.0):
        return similarity_scores_ref(queries, lower, upper, valid,
                                     alpha=alpha)


class KernelBackend(MatchBackend):
    name = "kernel"

    def feature_count_scores(self, queries, templates, valid=None):
        raise _later("the raw (B, M) match-count kernel (acam_match, B7a)")

    def similarity_scores(self, queries, lower, upper, valid=None, *,
                          alpha=1.0):
        raise _later("the raw similarity-score kernel (acam_similarity, B7b)")

    def _feature_count_only(self) -> None:
        if self.config.method != "feature_count":
            raise _later('the similarity kernels (method="similarity", B5/B6)')

    def _classify_kernel_path(self, features, thresholds, bank: TemplateBank):
        """One kernel call at any bank size: the fused K-major layout when
        the bank's K * Cp rows fit `MAX_FUSED_ROWS`, the (K, Cp, N) stack
        past it."""
        from repro_torch.kernels import layout
        from repro_torch.kernels.acam_match import ops as match_ops

        self._feature_count_only()
        c, k, _ = bank.templates.shape
        if k * layout.padded_classes(c) <= MAX_FUSED_ROWS:
            return match_ops.classify_fused(features, thresholds,
                                            bank.templates, bank.valid)
        pred, per_class, _ = match_ops.classify_fused_margins_chunked(
            features, thresholds, bank.templates, bank.valid,
            max_rows=MAX_FUSED_ROWS)
        return pred, per_class

    def classify(self, queries, bank):
        # binary {0,1} queries re-binarise exactly through 0.5 thresholds
        n = queries.shape[-1]
        half = torch.full((n,), 0.5, dtype=torch.float32,
                          device=queries.device)
        return self._classify_kernel_path(queries, half, bank)

    def classify_features(self, features, bank):
        return self._classify_kernel_path(features, bank.thresholds, bank)

    def classify_features_margin(self, features, bank, class_lo=None,
                                 class_hi=None):
        from repro_torch.kernels import layout
        from repro_torch.kernels.acam_match import ops as match_ops

        self._feature_count_only()
        c, k, _ = bank.templates.shape
        if k * layout.padded_classes(c) <= MAX_FUSED_ROWS:
            return match_ops.classify_fused_margins(
                features, bank.thresholds, bank.templates, bank.valid,
                class_lo, class_hi)
        return match_ops.classify_fused_margins_chunked(
            features, bank.thresholds, bank.templates, bank.valid, class_lo,
            class_hi, max_rows=MAX_FUSED_ROWS)

    def classify_serve(self, features, thr_table, tenant_slot, bank,
                       class_lo, class_hi, tau):
        """The whole tick in ONE `acam_match_serve` call, or the composed
        baseline under ``serve_fusion="compose"`` (bit-identical)."""
        if self.config.serve_fusion == "compose":
            return super().classify_serve(features, thr_table, tenant_slot,
                                          bank, class_lo, class_hi, tau)
        from repro_torch.kernels.acam_match import ops as match_ops

        self._feature_count_only()
        return match_ops.serve_classify(
            features, thr_table, tenant_slot, bank.templates, bank.valid,
            class_lo, class_hi, tau, max_rows=MAX_FUSED_ROWS)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[EngineConfig], MatchBackend]] = {
    "reference": ReferenceBackend,
    "kernel": KernelBackend,
}


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@functools.lru_cache(maxsize=None)
def backend_for(name: str, config: EngineConfig) -> MatchBackend:
    """Memoised backend instance per (name, config)."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown matching backend {name!r}; use "
                         f"{('auto',) + backend_names()}") from None
    return factory(config)
