"""ACAM pattern matching (paper §II-D-2, Eq. 8-12): deprecated shims.

The matching implementation lives in **`repro_torch.match`**: a
`MatchEngine` built from a hashable `EngineConfig` over a backend registry
(`reference` plain PyTorch oracles / `kernel` the CUDA kernels / `device`
the RRAM-CMOS physics of `repro_torch.core.acam`). New code should use it
directly:

    from repro_torch import match
    eng = match.engine_for(method="feature_count", backend="kernel")
    pred, per_class = eng.classify_features(features, bank)

This module keeps the JAX package's historical entry points as thin
delegating shims: `feature_count_scores`, `similarity_scores`, `classify`,
`classify_features`, `classify_features_margin`, `set_backend` /
`get_backend`, and the lazily resolved re-exports (`classify_scores`,
`winner_take_all`, `window_margin`, the `*_ref` oracles, `use_backend`, the
TINY_ELEMENTS / MAX_FUSED_ROWS constants). Nothing of `repro_torch.match`
is imported at module level: `repro_torch.match` itself imports
`repro_torch.core`.

`set_backend("auto" | "kernel" | "reference" | "device")` sets the process
default of `repro_torch.match` (as ``REPRO_MATCHING_BACKEND`` does), and
`use_backend(...)` scopes it to a `with` block; the ``backend=`` keyword of
each shim pins one call.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

    from repro_torch.core.templates import TemplateBank

NEG = float("-inf")

#: names resolved lazily from repro_torch.match on first attribute access
#: (PEP 562): matching <-> match would otherwise be an import cycle
_REEXPORTS = {
    "TINY_ELEMENTS", "MAX_FUSED_ROWS", "classify_scores", "winner_take_all",
    "window_margin", "feature_count_scores_ref", "similarity_scores_ref",
    "use_backend",
}

__all__ = sorted(_REEXPORTS | {
    "set_backend", "get_backend", "feature_count_scores",
    "similarity_scores", "classify", "classify_features",
    "classify_features_margin",
})


def __getattr__(name: str):
    if name in _REEXPORTS:
        import repro_torch.match as match_lib

        value = getattr(match_lib, name)
        globals()[name] = value  # cache: later lookups are direct
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def set_backend(name: str) -> None:
    """Set the process default backend (shim over
    `repro_torch.match.set_default_backend`)."""
    from repro_torch.match import set_default_backend

    set_default_backend(name)


def get_backend() -> str:
    """The process default backend name (shim)."""
    from repro_torch.match import default_backend

    return default_backend()


def feature_count_scores(queries: "torch.Tensor", templates: "torch.Tensor",
                         valid: "torch.Tensor | None" = None, *,
                         backend: str | None = None) -> "torch.Tensor":
    """Eq. 8: binary queries (B, N), binary templates (C, K, N) -> (B, C, K)
    match counts; invalid templates -inf (shim over `MatchEngine`)."""
    from repro_torch.match import engine_for

    return engine_for(backend=backend).feature_count_scores(
        queries, templates, valid)


def similarity_scores(queries: "torch.Tensor", lower: "torch.Tensor",
                      upper: "torch.Tensor",
                      valid: "torch.Tensor | None" = None, *,
                      alpha: float = 1.0, backend: str | None = None
                      ) -> "torch.Tensor":
    """Eq. 9-11: queries (B, N), windows (C, K, N) -> (B, C, K) similarity
    scores (shim over `MatchEngine`)."""
    from repro_torch.match import engine_for

    return engine_for(method="similarity", alpha=alpha,
                      backend=backend).similarity_scores(
        queries, lower, upper, valid)


def classify(queries: "torch.Tensor", bank: "TemplateBank", *,
             method: str = "feature_count", alpha: float = 1.0,
             backend: str | None = None):
    """Eq. 8/11 + Eq. 12 over *binary* queries -> (pred, per_class)."""
    from repro_torch.match import engine_for

    return engine_for(method=method, alpha=alpha,
                      backend=backend).classify(queries, bank)


def classify_features(features: "torch.Tensor", bank: "TemplateBank", *,
                      method: str = "feature_count", alpha: float = 1.0,
                      backend: str | None = None):
    """Raw front-end features -> binarise -> match -> WTA -> (pred,
    per_class); one fused kernel call on the kernel backend."""
    from repro_torch.match import engine_for

    return engine_for(method=method, alpha=alpha,
                      backend=backend).classify_features(features, bank)


def classify_features_margin(features: "torch.Tensor", bank: "TemplateBank",
                             class_lo: "torch.Tensor | None" = None,
                             class_hi: "torch.Tensor | None" = None, *,
                             method: str = "feature_count",
                             alpha: float = 1.0, backend: str | None = None):
    """`classify_features` + the per-request confidence margin -> (pred (B,)
    int32, per_class (B, C), margin (B,) f32 clamped to the backend's score
    range: N for feature_count, 1 for similarity and the device backend).
    Empty windows give pred 0, margin 0."""
    from repro_torch.match import engine_for

    return engine_for(method=method, alpha=alpha,
                      backend=backend).classify_features_margin(
        features, bank, class_lo, class_hi)
