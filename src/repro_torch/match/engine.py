"""The matching engine: one API over the backend registry (one device).

`MatchEngine` is the entry point every caller (`repro_torch.core.hybrid`,
`repro_torch.serve.*`) routes Eq. 8-12 template matching through:

    eng = engine_for(method="feature_count", backend="kernel")
    pred, per_class = eng.classify_features(features, bank)

Engines are memoised per `EngineConfig`. The process default backend (what
``backend=None`` resolves to) is ``REPRO_MATCHING_BACKEND`` at import,
"auto" otherwise; `use_backend` scopes a change to a ``with`` block. "auto"
picks the kernel backend for CUDA operands at every shape; on the CPU it
keeps the JAX package's tiny-shape rule (`backends.tiny_cutoff`), under
which both backends give the same bits.

Sharded execution over several cards (the JAX package's `PartitionPlan`)
comes with the multi-GPU slice of the port.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch

from repro_torch.core.templates import TemplateBank
from repro_torch.match.backends import (MatchBackend, backend_for,
                                        backend_names, tiny_cutoff)
from repro_torch.match.config import EngineConfig, validate

_default_backend = os.environ.get("REPRO_MATCHING_BACKEND", "auto")


def default_backend() -> str:
    """The process default backend name ("auto" unless overridden)."""
    return _default_backend


def set_default_backend(name: str) -> None:
    """Set the process default backend ("auto" or any registered name)."""
    global _default_backend
    if name != "auto" and name not in backend_names():
        raise ValueError(f"unknown matching backend {name!r}; use "
                         f"{('auto',) + backend_names()}")
    _default_backend = name


@contextlib.contextmanager
def use_backend(name: str):
    """Scope the default backend to a `with` block."""
    prev = default_backend()
    set_default_backend(name)
    try:
        yield
    finally:
        set_default_backend(prev)


class MatchEngine:
    """Pluggable Eq. 8-12 matching over a `TemplateBank`."""

    def __init__(self, config: EngineConfig = EngineConfig()):
        validate(config, backend_names())
        self.config = config

    def __repr__(self) -> str:
        return f"MatchEngine({self.config!r})"

    def backend(self, operand: torch.Tensor, bank: TemplateBank
                ) -> MatchBackend:
        """Resolve the backend for one call ("auto": kernel on CUDA, the
        tiny-shape rule on the CPU)."""
        name = self.config.backend
        if name == "auto":
            c, k, n = bank.templates.shape
            tiny = operand.shape[0] * c * k * n < tiny_cutoff(
                self.config.method)
            name = "reference" if tiny and not operand.is_cuda else "kernel"
        return backend_for(name, self.config)

    def classify(self, queries, bank: TemplateBank):
        """Eq. 8/11 + Eq. 12 over *binary* queries -> (pred, per_class)."""
        return self.backend(queries, bank).classify(queries, bank)

    def classify_features(self, features, bank: TemplateBank):
        """Raw features -> binarise -> match -> WTA -> (pred, per_class);
        one kernel call on the kernel backend."""
        return self.backend(features, bank).classify_features(features, bank)

    def classify_features_margin(self, features, bank: TemplateBank,
                                 class_lo=None, class_hi=None):
        """`classify_features` + the per-request confidence margin.

        Returns (pred (B,) int32 global class index, per_class (B, C),
        margin (B,) f32 clamped to the score range). Empty class windows
        give pred 0, margin 0.
        """
        b, c = features.shape[0], bank.templates.shape[0]
        dev = features.device
        if class_lo is None:
            class_lo = torch.zeros((b,), dtype=torch.int32, device=dev)
        if class_hi is None:
            class_hi = torch.full((b,), c, dtype=torch.int32, device=dev)
        return self.backend(features, bank).classify_features_margin(
            features, bank, class_lo, class_hi)

    def classify_serve(self, features, thr_table, tenant_slot,
                       bank: TemplateBank, class_lo=None, class_hi=None,
                       tau=None):
        """The multi-tenant serving tick: row i binarises against
        ``thr_table[tenant_slot[i]]``, classifies inside its class window,
        and ``escalate[i] = margin[i] < tau[i]`` (tau -inf: never).
        Returns (pred, per_class, margin, escalate); ONE `acam_match_serve`
        call on the kernel backend unless ``serve_fusion == "compose"``."""
        b, c = features.shape[0], bank.templates.shape[0]
        dev = features.device
        if class_lo is None:
            class_lo = torch.zeros((b,), dtype=torch.int32, device=dev)
        if class_hi is None:
            class_hi = torch.full((b,), c, dtype=torch.int32, device=dev)
        if tau is None:
            tau = torch.full((b,), float("-inf"), device=dev)
        return self.backend(features, bank).classify_serve(
            features, thr_table, tenant_slot, bank, class_lo, class_hi, tau)


@functools.lru_cache(maxsize=None)
def engine_from_config(config: EngineConfig) -> MatchEngine:
    """Memoised engine for a fully resolved `EngineConfig`."""
    return MatchEngine(config)


def engine_for(method: str = "feature_count", alpha: float = 1.0,
               backend: str | None = None) -> MatchEngine:
    """Memoised engine per config; ``backend=None`` -> the process default,
    resolved here at the caller boundary."""
    return engine_from_config(EngineConfig(
        method=method, alpha=alpha, backend=backend or default_backend()))
