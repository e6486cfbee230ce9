"""Matching backends: the implementations of Eq. 8-12 behind `MatchEngine`.

Every backend implements the same entry points over a `TemplateBank`:

  feature_count_scores(queries, templates, valid)            -> (B, C, K)
  similarity_scores(queries, lower, upper, valid, alpha)     -> (B, C, K)
  classify(queries, bank)              binary queries        -> (pred, per_class)
  classify_features(features, bank)    raw features          -> (pred, per_class)
  classify_features_margin(features, bank, lo, hi)           -> (pred, per_class, margin)
  classify_serve(features, thr_table, slot, bank, lo, hi, tau)
                                       multi-tenant tick     -> (pred, per_class, margin, escalate)

Backends:

  reference  plain PyTorch oracles (both methods) — the parity baseline.
  kernel     the hand-written CUDA kernels of `repro_torch.kernels.
             acam_match` (feature count) and `repro_torch.kernels.
             acam_similarity` (similarity), dispatched exactly as the JAX
             package's Pallas paths are: one kernel call per entry point,
             the K-major fused layout up to `MAX_FUSED_ROWS` rows and the
             (K, Cp, N) stack past it; the serving tick is one call of
             `acam_match_serve` / `acam_similarity_serve` (or the "compose"
             baseline); the ``*_scores`` entry points are the raw-score
             kernels. On CPU tensors each kernel runs its plain version.
  device     the RRAM-CMOS physics models of `repro_torch.core.acam` (§III),
             plain PyTorch on the operands' device: the bank is programmed
             into a (C*K)-row TXL array (point templates become lower ==
             upper windows), optionally with log-normal `sigma_program`
             write noise, and scores are the sense-amplifier outputs in
             matchline units (margins cap at 1.0, not N). `alpha` is ignored:
             the Eq. 9 distance is digital post-processing the matchline
             does not integrate.

Similarity scores follow the arithmetic order of
`repro_torch.kernels.acam_similarity.ref` everywhere (hit count, ``*
inv_n``, ``/ (1 + alpha * D)``), so the reference and kernel backends give
the JAX package's bits.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core import acam as acam_lib
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


# ---------------------------------------------------------------------------
# Shared epilogues and references (plain PyTorch)
# ---------------------------------------------------------------------------

def classify_scores(scores: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 12 with multi-template max-pooling: (B, C, K) -> (pred, per_class)."""
    per_class = scores.amax(dim=-1)
    return torch.argmax(per_class, dim=-1).to(torch.int32), per_class


def winner_take_all(per_class: torch.Tensor) -> torch.Tensor:
    """One-hot WTA output (the analogue WTA network's digital semantics)."""
    return torch.nn.functional.one_hot(
        torch.argmax(per_class, dim=-1), per_class.shape[-1]).to(
            torch.float32)


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
    """Eq. 9-11 reference over (C, K, N) windows -> (B, C, K), in the
    arithmetic order of `acam_similarity.ref` (the JAX package's bits)."""
    from repro_torch.kernels.acam_similarity.ref import acam_similarity_ref

    c, k, n = lower.shape
    s = acam_similarity_ref(queries, lower.reshape(c * k, n),
                            upper.reshape(c * k, n), alpha=alpha
                            ).reshape(queries.shape[0], c, k)
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


def _binary_thresholds(n: int, device) -> torch.Tensor:
    # binary {0,1} queries re-binarise exactly through a 0.5 threshold,
    # letting the kernels' fused binarisation pass them through
    return torch.full((n,), 0.5, dtype=torch.float32, device=device)


class KernelBackend(MatchBackend):
    name = "kernel"

    def feature_count_scores(self, queries, templates, valid=None):
        """The raw-count kernel (B7a) over the class-major flattened bank."""
        from repro_torch.kernels.acam_match import ops as match_ops

        b, n = queries.shape
        c, k, _ = templates.shape
        scores = match_ops.match_scores(
            queries, _binary_thresholds(n, queries.device),
            templates.reshape(c * k, n)).reshape(b, c, k)
        if valid is not None:
            scores = torch.where(valid[None, :, :], scores,
                                 torch.tensor(NEG, device=scores.device))
        return scores

    def similarity_scores(self, queries, lower, upper, valid=None, *,
                          alpha=1.0):
        """The raw similarity kernel (B7b) on the queries as given."""
        from repro_torch.kernels.acam_similarity import ops as sim_ops

        b, n = queries.shape
        c, k, _ = lower.shape
        s = sim_ops.similarity_scores(
            queries, lower.reshape(c * k, n), upper.reshape(c * k, n),
            alpha=alpha).reshape(b, c, k)
        if valid is not None:
            s = torch.where(valid[None, :, :], s,
                            torch.tensor(NEG, device=s.device))
        return s

    def _classify_kernel_path(self, features, thresholds, bank: TemplateBank):
        """One kernel call at any bank size: the fused K-major layout when
        the bank's K * Cp rows fit `MAX_FUSED_ROWS`, past it the (K, Cp, N)
        stack (feature count) or the serve kernel's margins face
        (similarity)."""
        from repro_torch.kernels import layout
        from repro_torch.kernels.acam_match import ops as match_ops
        from repro_torch.kernels.acam_similarity import ops as sim_ops

        alpha = self.config.alpha
        c, k, _ = bank.templates.shape
        fused = k * layout.padded_classes(c) <= MAX_FUSED_ROWS
        if self.config.method == "feature_count":
            if fused:
                return match_ops.classify_fused(features, thresholds,
                                                bank.templates, bank.valid)
            pred, per_class, _ = match_ops.classify_fused_margins_chunked(
                features, thresholds, bank.templates, bank.valid,
                max_rows=MAX_FUSED_ROWS)
            return pred, per_class
        if fused:
            return sim_ops.classify_fused(features, thresholds, bank.lower,
                                          bank.upper, bank.valid, alpha=alpha)
        pred, per_class, _ = sim_ops.classify_fused_margins(
            features, thresholds, bank.lower, bank.upper, bank.valid,
            alpha=alpha, max_rows=MAX_FUSED_ROWS)
        return pred, per_class

    def classify(self, queries, bank):
        return self._classify_kernel_path(
            queries, _binary_thresholds(queries.shape[-1], queries.device),
            bank)

    def classify_features(self, features, bank):
        return self._classify_kernel_path(features, bank.thresholds, bank)

    def classify_features_margin(self, features, bank, class_lo=None,
                                 class_hi=None):
        from repro_torch.kernels import layout
        from repro_torch.kernels.acam_match import ops as match_ops
        from repro_torch.kernels.acam_similarity import ops as sim_ops

        c, k, _ = bank.templates.shape
        if self.config.method == "similarity":
            # the serve kernel's margins face at any bank size (B6)
            return sim_ops.classify_fused_margins(
                features, bank.thresholds, bank.lower, bank.upper,
                bank.valid, class_lo, class_hi, alpha=self.config.alpha,
                max_rows=MAX_FUSED_ROWS)
        if k * layout.padded_classes(c) <= MAX_FUSED_ROWS:
            return match_ops.classify_fused_margins(
                features, bank.thresholds, bank.templates, bank.valid,
                class_lo, class_hi)
        return match_ops.classify_fused_margins_chunked(
            features, bank.thresholds, bank.templates, bank.valid, class_lo,
            class_hi, max_rows=MAX_FUSED_ROWS)

    def classify_serve(self, features, thr_table, tenant_slot, bank,
                       class_lo, class_hi, tau):
        """The whole tick in ONE `acam_match_serve` / `acam_similarity_serve`
        call, or the composed baseline under ``serve_fusion="compose"``
        (bit-identical)."""
        if self.config.serve_fusion == "compose":
            return super().classify_serve(features, thr_table, tenant_slot,
                                          bank, class_lo, class_hi, tau)
        from repro_torch.kernels.acam_match import ops as match_ops
        from repro_torch.kernels.acam_similarity import ops as sim_ops

        if self.config.method == "similarity":
            return sim_ops.serve_classify(
                features, thr_table, tenant_slot, bank.lower, bank.upper,
                bank.valid, class_lo, class_hi, tau, alpha=self.config.alpha,
                max_rows=MAX_FUSED_ROWS)
        return match_ops.serve_classify(
            features, thr_table, tenant_slot, bank.templates, bank.valid,
            class_lo, class_hi, tau, max_rows=MAX_FUSED_ROWS)


# ---------------------------------------------------------------------------
# device backend (RRAM-CMOS physics, repro_torch.core.acam)
# ---------------------------------------------------------------------------

class DeviceBackend(MatchBackend):
    """Matching through the §III TXL-ACAM behavioural models.

    The bank is flattened class-major into a (C*K, N) array and programmed
    (`acam.program`) on the operands' device. ``sigma_program > 0`` applies
    the log-normal RRAM write noise keyed by the engine config's seed
    (`acam.prng_key`), so noisy-hardware sweeps run through the same API as
    the ideal backends. Scores are `acam.sense` outputs: the matchline
    charge fraction (6T4R) or dual-rail survival fraction (3T1R).
    """

    name = "device"

    def __init__(self, config: EngineConfig):
        super().__init__(config)
        self.acam_config = config.device or acam_lib.ACAMConfig()

    @property
    def per_shard_noise(self) -> bool:
        """Per-shard programming keys (`EngineConfig.device_noise`): array s
        of an S-array tiling draws its noise from ``fold_in(key, s)``."""
        return self.config.device_noise == "per_shard"

    @property
    def supports_bank_sharding(self) -> bool:
        """Whether the bank may be cut into class-row shards (the JAX
        package's `PartitionPlan`): "global" noise draws one field per
        programmed array, so shards programmed apart would realise another
        layout; the ideal array (sigma 0) is row-independent."""
        return self.acam_config.sigma_program <= 0.0 or self.per_shard_noise

    def _program_rows(self, lower, upper, valid_flat, key=None
                      ) -> acam_lib.ProgrammedACAM:
        if key is None and self.acam_config.sigma_program > 0.0:
            key = acam_lib.prng_key(self.config.seed)
        return acam_lib.program(lower, upper, valid_flat, self.acam_config,
                                key, device=lower.device)

    def _bank_rows(self, bank: TemplateBank):
        c, k, n = bank.templates.shape
        if self.config.method == "feature_count":
            lo = hi = bank.templates.reshape(c * k, n)
        else:
            lo = bank.lower.reshape(c * k, n)
            hi = bank.upper.reshape(c * k, n)
        return lo, hi, bank.valid.reshape(c * k)

    def program_bank(self, bank: TemplateBank, key=None, *,
                     shard_index: int = 0, bank_shards: int = 1
                     ) -> acam_lib.ProgrammedACAM:
        """Bank -> the programmed (C*K, N) TXL array the engine matches
        against (public for calibration flows). ``key`` overrides the
        config-seed draw (the sweep's per-draw keys).

        Under ``device_noise="per_shard"`` the key is ``fold_in(key,
        shard_index)``, and ``bank_shards=S > 1`` emulates the S-array
        tiling on one card: class rows are programmed in S groups keyed
        ``fold_in(key, s)``.
        """
        lo, hi, valid = self._bank_rows(bank)
        sigma = self.acam_config.sigma_program
        if sigma <= 0.0 or not self.per_shard_noise:
            return self._program_rows(lo, hi, valid, key)
        base = (acam_lib.as_key(key) if key is not None
                else acam_lib.prng_key(self.config.seed))
        if bank_shards <= 1:
            return self._program_rows(lo, hi, valid,
                                      acam_lib.fold_in(base, shard_index))
        c = bank.templates.shape[0]
        if c % bank_shards:
            raise ValueError(
                f"per-shard programming emulation needs class rows ({c}) "
                f"divisible by bank_shards ({bank_shards})")
        rows = lo.shape[0] // bank_shards  # = (C/S) * K rows per array
        progs = [self._program_rows(lo[s * rows:(s + 1) * rows],
                                    hi[s * rows:(s + 1) * rows],
                                    valid[s * rows:(s + 1) * rows],
                                    acam_lib.fold_in(base, s))
                 for s in range(bank_shards)]
        return acam_lib.ProgrammedACAM(
            lower=torch.cat([p.lower for p in progs]),
            upper=torch.cat([p.upper for p in progs]),
            valid=torch.cat([p.valid for p in progs]),
            config=progs[0].config)

    def _sense_rows(self, prog: acam_lib.ProgrammedACAM, queries, c: int,
                    k: int) -> torch.Tensor:
        s = acam_lib.sense(prog, queries)  # (B, C*K), invalid rows -inf
        return s.reshape(queries.shape[0], c, k)

    def _valid_rows(self, valid, c: int, k: int, device) -> torch.Tensor:
        if valid is None:
            return torch.ones((c * k,), dtype=torch.bool, device=device)
        return valid.reshape(c * k)

    def feature_count_scores(self, queries, templates, valid=None):
        c, k, n = templates.shape
        flat = templates.reshape(c * k, n)
        prog = self._program_rows(
            flat, flat, self._valid_rows(valid, c, k, flat.device))
        return self._sense_rows(prog, queries, c, k)

    def similarity_scores(self, queries, lower, upper, valid=None, *,
                          alpha=1.0):
        # alpha (the Eq. 9/11 distance weight) is digital post-processing
        # the matchline does not integrate: the device senses Eq. 10's H
        del alpha
        c, k, n = lower.shape
        prog = self._program_rows(
            lower.reshape(c * k, n), upper.reshape(c * k, n),
            self._valid_rows(valid, c, k, lower.device))
        return self._sense_rows(prog, queries, c, k)

    def scores(self, queries, bank: TemplateBank) -> torch.Tensor:
        c, k, _ = bank.templates.shape
        return self._sense_rows(self.program_bank(bank), queries, c, k)

    def classify_features_keyed(self, features, bank: TemplateBank, key, *,
                                bank_shards: int = 1):
        """One Monte-Carlo draw: program the bank with an explicit key (not
        the config seed's) and classify -> (pred, per_class)."""
        c, k, _ = bank.templates.shape
        prog = self.program_bank(bank, key, bank_shards=bank_shards)
        q = quant.binarize(features, bank.thresholds)
        return classify_scores(self._sense_rows(prog, q, c, k))

    def margin_cap(self, num_features: int) -> float:
        return 1.0  # sense outputs live in [0, 1] matchline units


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[EngineConfig], MatchBackend]] = {
    "reference": ReferenceBackend,
    "kernel": KernelBackend,
    "device": DeviceBackend,
}


def register_backend(name: str,
                     factory: Callable[[EngineConfig], MatchBackend]) -> None:
    """Add (or replace) a backend. `factory(config)` -> MatchBackend."""
    if name == "auto":
        raise ValueError('"auto" is the engine dispatch policy, '
                         "not a backend name")
    _REGISTRY[name] = factory
    backend_for.cache_clear()  # a replaced factory must not serve stale hits


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
