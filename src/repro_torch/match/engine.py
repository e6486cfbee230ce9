"""The matching engine: one API over the backend registry and the mesh.

`MatchEngine` is the entry point every caller (`repro_torch.core.hybrid`,
`repro_torch.serve.*`) routes Eq. 8-12 template matching through:

    eng = engine_for(method="feature_count", backend="kernel")
    pred, per_class = eng.classify_features(features, bank)

Engines are memoised per `EngineConfig`. The process default backend (what
``backend=None`` resolves to) is ``REPRO_MATCHING_BACKEND`` at import,
"auto" otherwise; `use_backend` scopes a change to a ``with`` block. "auto"
picks the kernel backend for CUDA operands at every shape; on the CPU it
keeps the JAX package's tiny-shape rule (`backends.tiny_cutoff`), under
which both backends give the same bits. The backend is resolved once per
call, on the whole problem, so a sharded call runs the backend its
replicated twin runs. Both methods run on every backend; the device
backend also runs `MatchEngine.sweep_program_noise`, the Monte-Carlo sweep
over programming draws.

Mesh execution (the PartitionPlan layer)
----------------------------------------
When `repro_torch.distributed.context` holds a mesh, every call derives a
`repro_torch.match.plan.PartitionPlan` from its shapes and runs as the JAX
package's `shard_map` does, in one process (`MatchEngine._run`): the batch
operands are cut over the dp axes and the bank's class rows over the model
axis, each tile moves to its mesh device and runs the backend there, and
the outputs come back to the caller's device.

  * a **batch-only** plan runs the replicated entry point on each batch
    slice (one B3 serve kernel a slice on the kernel backend);
  * a **bank-sharded** plan runs the backend's shard entry point on each
    class-row shard, producing per-class partials and a (top1, global
    winner index[, top2]) summary, and one small cross-shard merge
    (`_reduce_winner` / `_reduce_margin`) recovers the exact global Eq. 12
    decision and windowed margin, bit-identically to replicated execution
    (ties resolve to the lowest global class index, as `torch.argmax`).
"""
from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import acam as acam_lib
from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve
from repro_torch.match import plan as plan_lib
from repro_torch.match.backends import (DeviceBackend, MatchBackend,
                                        backend_for, backend_names,
                                        tiny_cutoff)
from repro_torch.match.config import EngineConfig, validate
from repro_torch.match.plan import PartitionPlan, plan_for

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


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------

def dp_axes_in_mesh():
    """(mesh, dp_axes) from the distributed context, or (None, None) when
    no usable data-parallel mesh is installed."""
    mesh, axes = plan_lib.mesh_axes()
    if mesh is None:
        return None, None
    dp = axes.dp if isinstance(axes.dp, tuple) else (axes.dp,)
    if any(a not in mesh.axis_names for a in dp):
        return None, None
    if int(np.prod([mesh.shape[a] for a in dp])) <= 1:
        return None, None
    return mesh, dp


def _tile_device(mesh, plan: PartitionPlan, d: int, s: int) -> torch.device:
    """The mesh device holding tile (dp index d, bank shard s); axes the
    plan does not cut take index 0 (one replica runs, not all of them)."""
    coord = dict.fromkeys(mesh.axis_names, 0)
    if plan.dp:
        sizes = [mesh.shape[a] for a in plan.dp]
        coord.update(zip(plan.dp, np.unravel_index(d, sizes)))
    if plan.model is not None:
        coord[plan.model] = s
    return mesh.devices[tuple(int(coord[a]) for a in mesh.axis_names)]


def _bank_tile(arg, rows: slice, dev: torch.device):
    """A class-row operand's shard on ``dev``: a bank's class-row leading
    arrays are cut, its thresholds replicated."""
    if isinstance(arg, TemplateBank):
        return TemplateBank(arg.templates[rows].to(dev),
                            arg.lower[rows].to(dev),
                            arg.upper[rows].to(dev),
                            arg.valid[rows].to(dev),
                            arg.thresholds.to(dev))
    return arg[rows].to(dev)


def _cat(parts: list, dim: int, dev: torch.device) -> torch.Tensor:
    parts = [p.to(dev) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


# ---------------------------------------------------------------------------
# Cross-shard reduces (the "one tiny argmax reduce" of a bank-sharded call)
# ---------------------------------------------------------------------------
#
# Each shard contributes a (top1, global winner index[, top2]) summary of
# its class rows. Shards hold *disjoint* class-index ranges, so the merge
# is exact: the winner is the lexicographic max on (score desc, index
# asc), `torch.argmax`'s lowest-index tie rule, and the global runner-up
# over "all classes except the winner's position" is max(loser's top1,
# winner's top2). The operations and their order are the JAX package's:
#
#   allgather  all S partials, folded in shard order.
#   tree       the XOR butterfly: round d merges rank s with rank s ^ d,
#              log2(S) rounds (a power-of-two axis only). Every rank ends
#              with the same bits; the engine keeps rank 0's, the replica
#              the JAX package reads back.
#
# A NaN score never wins a merge it is the challenger of (both compares
# are false), and stays winner where it is the incumbent: the JAX sharded
# path's semantics, which can differ from `argmax` over all classes on NaN
# scores (ROADMAP.md, reference artifacts).

def _merge_winner(at, ai, bt, bi):
    take = (bt > at) | ((bt == at) & (bi < ai))
    return torch.where(take, bt, at), torch.where(take, bi, ai)


def _merge_margin(at, ai, ar, bt, bi, br):
    take = (bt > at) | ((bt == at) & (bi < ai))
    # new runner-up: the losing side's top1 joins the candidate set
    r = torch.where(take, torch.maximum(br, at), torch.maximum(ar, bt))
    return torch.where(take, bt, at), torch.where(take, bi, ai), r


def _butterfly(parts: list[tuple], merge) -> tuple:
    """Rank 0's result of the XOR-butterfly all-reduce of ``parts`` (one
    partial tuple per shard). Round d merges rank s with rank s ^ d; only
    the ranks rank 0 still reads are computed (S - 1 merges in all)."""
    parts = list(parts)
    d = 1
    while d < len(parts):
        for s in range(0, len(parts), 2 * d):
            parts[s] = merge(*parts[s], *parts[s + d])
        d *= 2
    return parts[0]


def _fold(parts: list[tuple], merge) -> tuple:
    best = parts[0]
    for p in parts[1:]:
        best = merge(*best, *p)
    return best


def _reduce_winner(parts: list[tuple], strategy: str = "allgather"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(top1, gidx) partials per shard -> (top1, pred)."""
    reduce = _butterfly if strategy == "tree" else _fold
    return reduce(parts, _merge_winner)


def _reduce_margin(parts: list[tuple], cap: float,
                   strategy: str = "allgather"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(top1, gidx, top2) partials per shard -> (pred, margin), as
    `repro_torch.kernels.layout.windowed_margin` computes them over all
    classes (the same clamp, an empty window's pred 0 / margin 0)."""
    reduce = _butterfly if strategy == "tree" else _fold
    best_t, best_i, best_r = reduce(parts, _merge_margin)
    top2g = torch.maximum(best_r, best_t - cap)
    margin = torch.where(torch.isfinite(best_t), best_t - top2g,
                         torch.zeros((), device=best_t.device))
    return best_i.to(torch.int32), margin.to(torch.float32)


class MatchEngine:
    """Pluggable, mesh-aware Eq. 8-12 matching over a `TemplateBank`."""

    def __init__(self, config: EngineConfig = EngineConfig()):
        validate(config, backend_names())
        self.config = config

    def __repr__(self) -> str:
        return f"MatchEngine({self.config!r})"

    def backend(self, operand: torch.Tensor, bank: TemplateBank
                ) -> MatchBackend:
        """Resolve the backend for one call ("auto": kernel on CUDA, the
        tiny-shape rule on the CPU), on the whole problem."""
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

    # -- plan-driven execution -----------------------------------------------

    def plan(self, batch: int, num_classes: int, be: MatchBackend):
        """``(plan, mesh)`` for a call of these shapes."""
        return plan_for(batch=batch, num_classes=num_classes,
                        bank_shardable=be.supports_bank_sharding)

    @staticmethod
    def _run(fn, batch_args: tuple, shared_args: tuple, bank_args: tuple,
             plan: PartitionPlan, mesh) -> list[list]:
        """What `shard_map` does, in one process: for every tile (dp index
        d, bank shard s) cut the batch operands to d's rows and the
        class-row operands to s's rows, move them and the shared operands
        to the tile's mesh device, and run ``fn(*batch, *shared, *bank,
        row0)`` there (``row0``: the shard's first global class row).
        Returns the outputs as ``grid[d][s]``, on the tiles' devices."""
        b = batch_args[0].shape[0]
        grid = []
        for d in range(plan.dp_devices):
            rows = plan.batch_slice(b, d)
            outs = []
            for s in range(plan.bank_shards):
                dev = _tile_device(mesh, plan, d, s)
                cls = plan.class_slice(s)
                args = ([a[rows].to(dev) for a in batch_args]
                        + [a.to(dev) for a in shared_args]
                        + [_bank_tile(a, cls, dev) for a in bank_args])
                outs.append(fn(*args, s * plan.rows_per_shard))
            grid.append(outs)
        return grid

    @staticmethod
    def _batch_outputs(grid: list[list], dev: torch.device) -> tuple:
        """A batch-only call's outputs: each dp slice's, concatenated."""
        return tuple(_cat([row[0][i] for row in grid], 0, dev)
                     for i in range(len(grid[0][0])))

    # -- raw score entry points (template arrays, not banks) -----------------

    def _raw_scores(self, queries, bank_args: tuple, valid, fn):
        b = queries.shape[0]
        c, k = bank_args[0].shape[0], bank_args[0].shape[1]
        be = self._backend(queries, bank_args[0])
        plan, mesh = self.plan(b, c, be)
        if not plan.sharded:
            return fn(be, queries, *bank_args, valid)
        if valid is None:
            valid = torch.ones((c, k), dtype=torch.bool,
                               device=queries.device)
        grid = self._run(lambda q, *rest: fn(be, q, *rest[:-1]),
                         (queries,), (), bank_args + (valid,), plan, mesh)
        return self._scores_out(grid, queries.device)

    @staticmethod
    def _scores_out(grid: list[list], dev: torch.device) -> torch.Tensor:
        return _cat([_cat(row, 1, dev) for row in grid], 0, dev)

    def feature_count_scores(self, queries, templates, valid=None):
        """Eq. 8: binary queries (B, N), templates (C, K, N) -> (B, C, K);
        the raw-count kernel on the kernel backend. Invalid rows -inf."""
        return self._raw_scores(
            queries, (templates,), valid,
            lambda be, q, t, v: be.feature_count_scores(q, t, v))

    def similarity_scores(self, queries, lower, upper, valid=None):
        """Eq. 9-11: queries (B, N), windows (C, K, N) -> (B, C, K) at the
        config's alpha; the raw similarity kernel on the kernel backend."""
        alpha = self.config.alpha
        return self._raw_scores(
            queries, (lower, upper), valid,
            lambda be, q, lo, hi, v: be.similarity_scores(q, lo, hi, v,
                                                          alpha=alpha))

    # -- bank entry points ---------------------------------------------------

    def scores(self, queries, bank: TemplateBank) -> torch.Tensor:
        """(B, C, K) scores for the configured method; invalid rows -inf."""
        be = self.backend(queries, bank)
        plan, mesh = self.plan(queries.shape[0], bank.templates.shape[0], be)
        if not plan.sharded:
            return be.scores(queries, bank)
        grid = self._run(lambda q, bk, row0: be.scores(q, bk), (queries,),
                         (), (bank,), plan, mesh)
        return self._scores_out(grid, queries.device)

    def _classify_via(self, shard_method: str, plain_method: str, queries,
                      bank: TemplateBank):
        with obs.span("repro_torch.match.classify"):
            be = self.backend(queries, bank)
            plan, mesh = self.plan(queries.shape[0], bank.templates.shape[0],
                                   be)
            plain = getattr(be, plain_method)
            if not plan.sharded:
                return plain(queries, bank)
            dev = queries.device
            if not plan.bank_sharded:
                grid = self._run(lambda q, bk, row0: plain(q, bk),
                                 (queries,), (), (bank,), plan, mesh)
                return self._batch_outputs(grid, dev)
            grid = self._run(getattr(be, shard_method), (queries,), (),
                             (bank,), plan, mesh)
            preds, per_class = [], []
            for row in grid:
                _, pred = _reduce_winner(
                    [(t.to(dev), i.to(dev)) for _, t, i in row],
                    plan.reduce)
                preds.append(pred)
                per_class.append(_cat([pc for pc, _, _ in row], 1, dev))
            return _cat(preds, 0, dev), _cat(per_class, 0, dev)

    def classify(self, queries, bank: TemplateBank):
        """Eq. 8/11 + Eq. 12 over *binary* queries -> (pred, per_class)."""
        return self._classify_via("classify_shard", "classify", queries,
                                  bank)

    def classify_features(self, features, bank: TemplateBank):
        """Raw features -> binarise -> match -> WTA -> (pred, per_class);
        one kernel call on the kernel backend, one a shard under a
        bank-sharded plan (the winner from the cross-shard merge)."""
        return self._classify_via("classify_features_shard",
                                  "classify_features", features, bank)

    def _margin_outputs(self, grid: list[list], cap: float, plan,
                        dev: torch.device, tau=None) -> list[torch.Tensor]:
        """A bank-sharded margin call's outputs from its partials: (pred,
        per_class, margin[, escalate = margin < tau])."""
        preds, per_class, margins = [], [], []
        for row in grid:
            pred, margin = _reduce_margin(
                [(t.to(dev), i.to(dev), r.to(dev)) for _, t, i, r in row],
                cap, plan.reduce)
            preds.append(pred)
            margins.append(margin)
            per_class.append(_cat([out[0] for out in row], 1, dev))
        outs = [_cat(preds, 0, dev), _cat(per_class, 0, dev),
                _cat(margins, 0, dev)]
        if tau is not None:
            outs.append(outs[2] < tau)
        return outs

    def classify_features_margin(self, features, bank: TemplateBank,
                                 class_lo=None, class_hi=None):
        """`classify_features` + the per-request confidence margin.

        Returns (pred (B,) int32 global class index, per_class (B, C),
        margin (B,) f32 clamped to the score range). Empty class windows
        give pred 0, margin 0. Windows are global class indices and may
        straddle bank shards: the margin merge is exact either way.
        """
        b, c = features.shape[0], bank.templates.shape[0]
        dev = features.device
        if class_lo is None:
            class_lo = torch.zeros((b,), dtype=torch.int32, device=dev)
        if class_hi is None:
            class_hi = torch.full((b,), c, dtype=torch.int32, device=dev)
        be = self.backend(features, bank)
        plan, mesh = self.plan(b, c, be)
        if not plan.sharded:
            return be.classify_features_margin(features, bank, class_lo,
                                               class_hi)
        if not plan.bank_sharded:
            grid = self._run(
                lambda f, lo, hi, bk, row0:
                be.classify_features_margin(f, bk, lo, hi),
                (features, class_lo, class_hi), (), (bank,), plan, mesh)
            return self._batch_outputs(grid, dev)
        grid = self._run(
            lambda f, lo, hi, bk, row0:
            be.classify_features_margin_shard(f, bk, lo, hi, row0),
            (features, class_lo, class_hi), (), (bank,), plan, mesh)
        return tuple(self._margin_outputs(
            grid, be.margin_cap(features.shape[-1]), plan, dev))

    def classify_serve(self, features, thr_table, tenant_slot,
                       bank: TemplateBank, class_lo=None, class_hi=None,
                       tau=None):
        """The multi-tenant serving tick: row i binarises against
        ``thr_table[tenant_slot[i]]``, classifies inside its class window,
        and ``escalate[i] = margin[i] < tau[i]`` (tau -inf: never).
        Returns (pred, per_class, margin, escalate); ONE `acam_match_serve`
        call on the kernel backend unless ``serve_fusion == "compose"``,
        one a batch slice under a batch-only plan. Under a bank-sharded
        plan each shard serves its class rows, `plan.reduce` picks the
        merge, and the tau compare runs on the merged margin."""
        b, c = features.shape[0], bank.templates.shape[0]
        dev = features.device
        if class_lo is None:
            class_lo = torch.zeros((b,), dtype=torch.int32, device=dev)
        if class_hi is None:
            class_hi = torch.full((b,), c, dtype=torch.int32, device=dev)
        if tau is None:
            tau = torch.full((b,), float("-inf"), device=dev)
        be = self.backend(features, bank)
        plan, mesh = self.plan(b, c, be)
        if not plan.sharded:
            return be.classify_serve(features, thr_table, tenant_slot, bank,
                                     class_lo, class_hi, tau)
        if not plan.bank_sharded:
            grid = self._run(
                lambda f, slot, lo, hi, t, thr, bk, row0:
                be.classify_serve(f, thr, slot, bk, lo, hi, t),
                (features, tenant_slot, class_lo, class_hi, tau),
                (thr_table,), (bank,), plan, mesh)
            return self._batch_outputs(grid, dev)
        grid = self._run(
            lambda f, slot, lo, hi, thr, bk, row0:
            be.classify_serve_shard(f, thr, slot, bk, lo, hi, row0),
            (features, tenant_slot, class_lo, class_hi), (thr_table,),
            (bank,), plan, mesh)
        return tuple(self._margin_outputs(
            grid, be.margin_cap(features.shape[-1]), plan, dev, tau))

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
        tiling (array s keyed ``fold_in(draw_key, s)``, the layout a
        bank-sharded plan realises per shard); ``bank_shards`` picks S,
        None reads it from the installed mesh (`plan.bank_shards_in_mesh`,
        1 with none), and a class count S does not divide falls back to
        one array. Ignored under "global" noise.
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
            if bank_shards is None:
                bank_shards = plan_lib.bank_shards_in_mesh()
            shards = bank_shards if c % bank_shards == 0 else 1
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
