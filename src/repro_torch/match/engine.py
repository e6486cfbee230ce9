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
which both backends give the same bits. Both methods run on every backend,
through the classify entry points and the raw ``*_scores`` ones; the device
backend also runs `MatchEngine.sweep_program_noise`, the Monte-Carlo sweep
over programming draws.

Sharded execution over several cards (the JAX package's `PartitionPlan`)
comes with the multi-GPU slice of the port.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch

from repro_torch.core import acam as acam_lib
from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve
from repro_torch.match.backends import (DeviceBackend, MatchBackend,
                                        backend_for, backend_names,
                                        tiny_cutoff)
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
        return self._backend(operand, bank.templates)

    def _backend(self, operand: torch.Tensor, bank_operand: torch.Tensor
                 ) -> MatchBackend:
        name = self.config.backend
        if name == "auto":
            c, k, n = bank_operand.shape
            tiny = operand.shape[0] * c * k * n < tiny_cutoff(
                self.config.method)
            name = "reference" if tiny and not operand.is_cuda else "kernel"
        return backend_for(name, self.config)

    def feature_count_scores(self, queries, templates, valid=None):
        """Eq. 8: binary queries (B, N), templates (C, K, N) -> (B, C, K);
        the raw-count kernel on the kernel backend. Invalid rows -inf."""
        return self._backend(queries, templates).feature_count_scores(
            queries, templates, valid)

    def similarity_scores(self, queries, lower, upper, valid=None):
        """Eq. 9-11: queries (B, N), windows (C, K, N) -> (B, C, K) at the
        config's alpha; the raw similarity kernel on the kernel backend."""
        return self._backend(queries, lower).similarity_scores(
            queries, lower, upper, valid, alpha=self.config.alpha)

    def scores(self, queries, bank: TemplateBank) -> torch.Tensor:
        """(B, C, K) scores for the configured method; invalid rows -inf."""
        return self.backend(queries, bank).scores(queries, bank)

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

    def __call__(self, features, bank: TemplateBank, class_lo=None,
                 class_hi=None):
        """Config-directed forward: margins when `config.margin` is set."""
        if self.config.margin:
            return self.classify_features_margin(features, bank, class_lo,
                                                 class_hi)
        return self.classify_features(features, bank)

    def sweep_program_noise(self, features, bank: TemplateBank, keys, *,
                            bank_shards: int | None = None, device=None):
        """Classify under M independent `sigma_program` programming draws,
        on ``device`` (the card unless the caller asks for the CPU): point
        accuracies become confidence intervals on noisy hardware.

        keys: an int M (per-draw keys ``acam.split(prng_key(config.seed),
        M)``), or a sequence of per-draw keys (seeds, key paths or
        `torch.Generator`s). Returns (pred (M, B) int32, per_class (M, B,
        C)). Requires ``backend="device"``; at ``sigma_program = 0`` every
        draw is the ideal array. The draws run one after another, so one
        (B, C*K, N) comparison is live at a time.

        Under ``device_noise="per_shard"`` each draw programs the S-array
        tiling (array s keyed ``fold_in(draw_key, s)``); ``bank_shards``
        picks S (None: 1, one card), and a class count S does not divide
        falls back to one array. Ignored under "global" noise.
        """
        name = self.config.backend
        be = backend_for(name, self.config) if name != "auto" else None
        if not isinstance(be, DeviceBackend):
            raise ValueError(
                "sweep_program_noise requires the device backend; build the "
                'engine with engine_for(backend="device", device=ACAMConfig('
                "sigma_program=...))")
        dev = resolve(device)
        features = torch.as_tensor(features, dtype=torch.float32, device=dev)
        bank = TemplateBank(*(x.to(dev) for x in bank))
        shards = 1
        if be.per_shard_noise:
            c = bank.templates.shape[0]
            shards = bank_shards or 1
            shards = shards if c % shards == 0 else 1
        if isinstance(keys, int):
            keys = acam_lib.split(acam_lib.prng_key(self.config.seed), keys)
        preds, per_class = [], []
        for key in keys:
            p, pc = be.classify_features_keyed(features, bank, key,
                                               bank_shards=shards)
            preds.append(p)
            per_class.append(pc)
        return torch.stack(preds), torch.stack(per_class)


@functools.lru_cache(maxsize=None)
def engine_from_config(config: EngineConfig) -> MatchEngine:
    """Memoised engine for a fully resolved `EngineConfig`."""
    return MatchEngine(config)


def engine_for(method: str = "feature_count", alpha: float = 1.0,
               backend: str | None = None,
               device: acam_lib.ACAMConfig | None = None, seed: int = 0,
               device_noise: str = "global") -> MatchEngine:
    """Memoised engine per config; ``backend=None`` -> the process default,
    resolved here at the caller boundary. ``device``, ``seed`` and
    ``device_noise`` configure the device-physics backend."""
    return engine_from_config(EngineConfig(
        method=method, alpha=alpha, backend=backend or default_backend(),
        device=device, seed=seed, device_noise=device_noise))
