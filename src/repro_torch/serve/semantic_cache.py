"""ACAM semantic cache of the port: template routing in front of the LM
decode engine.

The JAX package's `repro.serve.semantic_cache`. The ACAM tier fronts the
decode engine (`repro_torch.serve.engine.Engine`) as a semantic cache
router:

    prompt --featurize--> (N,) features --submit--> ACAM micro-batch tick
        ONE `classify_serve` call over the per-tenant template bank (the
        serve kernel, B3 on the card: margin and escalation bit included)
    confident hit  -> answer from the bounded LRU response store
                      (charged Eq. 14 E_backend only: rows x N x 185 fJ)
    miss           -> escalate to `Engine.generate`; the response (and its
                      embedding) is policy-gated admitted back into the
                      bank through the registry's hot `update` (the bank
                      always spans `router.max_templates` rows)

`SemanticCacheService` subclasses `HybridService`: `from_spec` (with
`cascade.backend="lm"`), live `reconfigure` (cnn <-> lm swaps drain queued
work under the old backend first), `snapshot` / `restore` (the response
store and the cache-tenant set ride the service snapshot, in the JAX
package's format, so a snapshot crosses between the packages) and the
flight recorder's cache counters and energy ledger
(`repro_torch.core.energy.lm_decode_energy` for decode misses).

Hit policy: the tick's Eq. 12 margin (``margin >= tau``) AND the winner's
absolute score against `router.hit_score` x perfect-match. Cold banks (all
rows invalid) serve margin 0 and always escalate, so a fresh tenant never
fabricates a hit.

Featurizers (prompt -> the matcher's N-feature space): ``hashing``
(seeded token uni+bigram signatures, a dense Rademacher vector per gram;
pure Python and numpy, the JAX package's exact bits) and ``embedding``
(mean-pooled model embedding rows through a seeded Rademacher projection).

Determinism: with the cache disabled (`router.enabled=False`) every prompt
escalates in admission order through ONE `Engine.generate` call per tick,
so routed outputs are token-identical to `Engine` alone; with caching on,
a hit serves the exact token tuple decode produced when the template was
admitted.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core import energy as energy_lib
from repro_torch.core.templates import TemplateBank
from repro_torch.serve import engine as engine_lib
from repro_torch.serve.acam_service import (ClassifyRequest,
                                            ClassifyResponse, _TenantRuntime)
from repro_torch.serve.control import HybridService
from repro_torch.serve.scheduler import SlotResult

_MASK = (1 << 64) - 1


def _mix64(h: int, v: int) -> int:
    """One splitmix64 round — deterministic across platforms/processes."""
    h = (h ^ (v & _MASK)) & _MASK
    h = (h * 0xBF58476D1CE4E5B9) & _MASK
    h ^= h >> 27
    h = (h * 0x94D049BB133111EB) & _MASK
    h ^= h >> 31
    return h


def hashing_featurizer(num_features: int, *,
                       seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """Seeded token n-gram signatures over ``num_features`` buckets.

    Every unigram and bigram contributes a DENSE Rademacher (+-1) vector
    keyed by its splitmix64 hash; the prompt signature is their sum,
    binarised downstream by the zero thresholds. Dense, not sparse-probe,
    on purpose: the matcher's feature_count scoring counts agreeing 0-bits
    too, so a sparse scheme lets two short unrelated prompts agree on all
    the buckets neither touched — straight past the hit_score floor.
    Dense sums put unrelated prompts at ~N/2 agreement (binomial, far
    below the 0.9N floor) while identical prompts agree exactly. The gram
    count 2S-1 is odd, so no bucket ever sums to a 0/1-ambiguous zero."""
    base = _mix64(0x9E3779B97F4A7C15, seed)

    def featurize(tokens) -> np.ndarray:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        v = np.zeros((num_features,), np.float32)
        grams: list[tuple[int, ...]] = [(t,) for t in toks]
        grams += list(zip(toks, toks[1:]))
        for g in grams:
            h = _mix64(base, len(g))
            for t in g:
                h = _mix64(h, t + 1)
            rng = np.random.default_rng(h)  # Philox: platform-stable
            v += rng.integers(0, 2, num_features).astype(np.float32) * 2 - 1
        return v

    return featurize


def embedding_featurizer(embed_table: np.ndarray, *, num_features: int,
                         seed: int = 0) -> Callable[[np.ndarray], np.ndarray]:
    """Mean-pool the model's own embedding rows, then a seeded Rademacher
    projection (d_model -> N): the backbone->ACAM-head idiom for prompts.
    ``embed_table`` is the LM's (vocab, d_model) embedding matrix (e.g.
    ``engine.params.embed``), a tensor on any device or an array."""
    if isinstance(embed_table, torch.Tensor):
        embed_table = embed_table.detach().to("cpu", torch.float32).numpy()
    table = np.asarray(embed_table, np.float32)
    rng = np.random.default_rng(seed)
    proj = rng.choice(np.float32([-1.0, 1.0]),
                      size=(table.shape[1], num_features))

    def featurize(tokens) -> np.ndarray:
        toks = np.asarray(tokens, np.int64).reshape(-1)
        pooled = table[toks].mean(axis=0)
        return (pooled @ proj).astype(np.float32)

    return featurize


@dataclasses.dataclass(frozen=True)
class PromptRequest:
    """One LM request as the router sees it."""

    tenant_id: str
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int = 16
    eos_id: int | None = None


@dataclasses.dataclass(frozen=True)
class RoutedResponse:
    request_id: int
    tenant_id: str
    tokens: tuple[int, ...]  # generated tokens (cached or fresh decode)
    cache_hit: bool
    template_id: int  # tenant-local bank row served / admitted; -1 none
    margin: float  # Eq. 12 margin at the match stage
    score: float  # winner's absolute match score (native units)
    energy_j: float  # E_backend (+ per-token decode energy on a miss)
    latency_s: float  # submit -> response wall time
    error: str | None = None


class ResponseStore:
    """Bounded global-LRU store of decoded responses, keyed
    ``(tenant_id, template_row)``. Eviction is reported to the service so
    the invariant *a valid template row always has a stored response*
    holds — a matched template whose response vanished would otherwise
    serve nothing."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: OrderedDict[tuple[str, int], tuple[int, ...]] = OrderedDict()

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key: tuple[str, int]) -> tuple[int, ...] | None:
        """LRU-refreshing read."""
        toks = self._d.get(key)
        if toks is not None:
            self._d.move_to_end(key)
        return toks

    def put(self, key: tuple[str, int],
            tokens: tuple[int, ...]) -> list[tuple[str, int]]:
        """Insert/replace; returns the keys evicted by capacity pressure."""
        self._d[key] = tuple(int(t) for t in tokens)
        self._d.move_to_end(key)
        evicted = []
        while len(self._d) > self.capacity:
            evicted.append(self._d.popitem(last=False)[0])
        return evicted

    def pop(self, key: tuple[str, int]) -> None:
        self._d.pop(key, None)

    def oldest_row(self, tenant_id: str) -> int | None:
        """The tenant's least-recently-used template row (its in-bank LRU
        victim when the bank is full)."""
        for (tid, row) in self._d:
            if tid == tenant_id:
                return row
        return None

    def state(self) -> list:
        """JSON-serialisable state, oldest-first — `load_state` replays it
        in order, so the LRU order round-trips exactly."""
        return [[tid, int(row), list(toks)]
                for (tid, row), toks in self._d.items()]

    def load_state(self, entries: list) -> None:
        self._d.clear()
        for tid, row, toks in entries:
            self._d[(str(tid), int(row))] = tuple(int(t) for t in toks)


@dataclasses.dataclass
class _TemplateSlots:
    """Host mirror of one cache tenant's bank occupancy (the registry's
    packed arrays hold the same bytes; this keeps the per-row bookkeeping
    O(max_templates) without slicing the super-bank)."""

    bits: np.ndarray  # (C, N) float32 {0,1} binarised embeddings
    valid: np.ndarray  # (C,) bool


class SemanticCacheService(HybridService):
    """`HybridService` with the LM decode engine as the cascade backend.

    Build with ``cascade.backend="lm"`` and attach the expensive backend:

        spec = ServiceSpec(cascade=CascadeSpec(backend="lm", tau=8.0),
                           router=RouterSpec(max_templates=32))
        svc = SemanticCacheService.from_spec(spec, engine=engine)
        svc.add_tenant("edge-0")
        svc.submit_prompt(PromptRequest("edge-0", prompt_tokens))
        (resp,) = svc.step_routed()

    The engine (model params) is deliberately NOT serialised in snapshots;
    `restore(...)` rebuilds the router state bit-identically and the
    engine is re-attached — restored hits serve without any engine at all.
    """

    # -- construction -------------------------------------------------------

    @classmethod
    def from_spec(cls, spec, *, engine: engine_lib.Engine | None = None,
                  featurizer=None, device=None) -> "SemanticCacheService":
        """Build on ``device`` (the card unless the caller asks for the
        CPU); the engine runs where its params live."""
        svc = super().from_spec(spec, device=device)
        svc.attach_backend(engine, featurizer=featurizer)
        return svc

    def _build(self, spec, device) -> None:
        super()._build(spec, device)
        self._store = ResponseStore(spec.router.response_capacity)
        self._templates: dict[str, _TemplateSlots] = {}
        self._jobs: dict[int, PromptRequest] = {}
        self._decoded: dict[int, tuple[int, ...]] = {}
        self._decode_j: dict[int, float] = {}
        self._backend_engine: engine_lib.Engine | None = None
        self._featurize = None
        self._active_params = 0

    def attach_backend(self, engine: engine_lib.Engine | None, *,
                       featurizer=None) -> None:
        """Attach (or re-attach, after restore) the decode engine and the
        prompt featurizer. ``featurizer=None`` builds the spec's choice:
        "hashing" needs nothing; "embedding" pulls the embedding table off
        the engine's params (and therefore needs the engine)."""
        self._backend_engine = engine
        if engine is not None:
            self._active_params = engine.cfg.active_param_count()
        n = self.registry.num_features
        rtr = self.spec.router
        if featurizer is not None:
            self._featurize = featurizer
        elif rtr.featurizer == "embedding":
            # needs the embedding table: defer until an engine arrives
            # (restore boots engine-less first, then re-attaches)
            self._featurize = None if engine is None else \
                embedding_featurizer(
                    engine.params.embed, num_features=n,
                    seed=rtr.featurizer_seed)
        else:
            self._featurize = hashing_featurizer(n, seed=rtr.featurizer_seed)

    def _apply_cascade(self, spec) -> None:
        super()._apply_cascade(spec)
        # reconfigure path: capacity changes apply lazily (next put evicts
        # down); guard because the base _build calls this before the
        # router containers exist
        if hasattr(self, "_store"):
            self._store.capacity = spec.router.response_capacity

    # -- tenant lifecycle ---------------------------------------------------

    def add_tenant(self, tenant_id: str, *,
                   margin_tau: float | None = None) -> None:
        """Register a cache tenant: a `router.max_templates`-row bank
        (k = 1), every row invalid — everything escalates until the first
        admission. `has_head=True` marks the escalation path live (the
        "head" is the attached decode engine, not a (W, b) table)."""
        rtr = self.spec.router
        n = self.registry.num_features
        slots = _TemplateSlots(
            bits=np.zeros((rtr.max_templates, n), np.float32),
            valid=np.zeros((rtr.max_templates,), bool))
        entry = self.registry.register(tenant_id, self._as_bank(slots))
        self._templates[tenant_id] = slots
        self._tenants[tenant_id] = _TenantRuntime(
            has_head=True, raw_tau=margin_tau,
            margin_tau=self._resolve_tau(margin_tau),
            backend_j=energy_lib.backend_energy(entry.valid_rows, n))

    def evict_tenant(self, tenant_id: str) -> None:
        super().evict_tenant(tenant_id)
        if tenant_id in self._templates:
            del self._templates[tenant_id]
            for key in [k for k in self._store._d if k[0] == tenant_id]:
                self._store.pop(key)

    def _as_bank(self, slots: _TemplateSlots) -> TemplateBank:
        t = slots.bits[:, None, :]  # (C, 1, N) — k = 1 bit-signatures
        return TemplateBank(
            templates=t, lower=t, upper=t,
            valid=slots.valid[:, None],
            thresholds=np.zeros((slots.bits.shape[1],), np.float32))

    def _sync_bank(self, tenant_id: str) -> None:
        """Push a tenant's host template slots into the registry's packed
        arrays (hot `update`: the bank always spans max_templates rows, so
        it re-uses its allocated range: the tick's shapes stay fixed) and
        refresh the Eq. 14 row-count energy."""
        slots = self._templates[tenant_id]
        entry = self.registry.update(tenant_id, self._as_bank(slots))
        rt = self._tenants[tenant_id]
        rt.backend_j = energy_lib.backend_energy(
            entry.valid_rows, self.registry.num_features)

    # -- request path -------------------------------------------------------

    def submit_prompt(self, req: PromptRequest) -> int:
        """Featurize + admit one LM request; returns the request id."""
        if req.tenant_id not in self._templates:
            raise ValueError(f"{req.tenant_id!r} is not a cache tenant "
                             "(add_tenant first)")
        if self._featurize is None:
            raise RuntimeError(
                'router.featurizer="embedding" derives its projection from '
                "the engine's embedding table — attach_backend(engine) "
                "first (or pass an explicit featurizer)")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        feats = np.asarray(self._featurize(prompt), np.float32)
        rid = self.submit(ClassifyRequest(tenant_id=req.tenant_id,
                                          features=feats))
        self._jobs[rid] = dataclasses.replace(req, prompt=prompt)
        return rid

    def _score_floor(self) -> float | None:
        hs = self.spec.router.hit_score
        if hs is None:
            return None
        cap = 1.0 if self.spec.native_tau_units == "fraction" \
            else float(self.registry.num_features)
        return hs * cap

    def _wants_escalation(self, r: SlotResult) -> bool:
        if r.item.request_id not in self._jobs:
            return super()._wants_escalation(r)  # plain classify traffic
        if not self.spec.router.enabled:
            return True  # shadow mode: every prompt decodes
        if r.escalate:  # in-kernel margin < tau
            return True
        floor = self._score_floor()
        return floor is not None and r.score < floor

    def _frontend_cost(self, request_id: int) -> float:
        cost = self._decode_j.get(request_id)
        return cost if cost is not None else super()._frontend_cost(
            request_id)

    def _run_escalation(self, escalate: list[SlotResult]) -> dict[int, int]:
        """Route a tick's escalations: job-backed slots (LM prompts) decode
        through ONE `Engine.generate` call in slot order; anything else
        (classify tenants sharing the service) falls through to the base
        dense-head dispatch."""
        misses = [r for r in escalate if r.item.request_id in self._jobs]
        rest = [r for r in escalate if r.item.request_id not in self._jobs]
        out: dict[int, int] = {}
        if rest:
            out.update(super()._run_escalation(rest))
        if not misses:
            return out
        if self._backend_engine is None:
            raise RuntimeError(
                'cascade.backend="lm" escalation needs a decode engine: '
                "SemanticCacheService.from_spec(spec, engine=...) or "
                "attach_backend(engine)")
        jobs = [self._jobs[r.item.request_id] for r in misses]
        reqs = [engine_lib.Request(prompt=j.prompt,
                                   max_new_tokens=j.max_new_tokens,
                                   eos_id=j.eos_id) for j in jobs]
        self._backend_engine.generate(reqs)
        rtr = self.spec.router
        paper = self.spec.cascade.paper_faithful
        for r, job, req in zip(misses, jobs, reqs):
            rid = r.item.request_id
            tokens = tuple(int(t) for t in req.out)
            self._decoded[rid] = tokens
            self._decode_j[rid] = energy_lib.lm_decode_energy(
                self._active_params, len(job.prompt) + len(tokens),
                paper_faithful=paper)
            row = -1
            if rtr.enabled and rtr.admit_on_miss:
                row = self._admit(job.tenant_id, r.item.features, tokens)
            out[rid] = row
        return out

    def _admit(self, tenant_id: str, feats: np.ndarray,
               tokens: tuple[int, ...]) -> int:
        """Admit one miss back into the bank: pick a free row (else the
        tenant's LRU row), write the binarised embedding, store the
        response, and invalidate any template whose response the store's
        capacity pressure pushed out — atomically from the service's view
        (all before the next tick gathers the bank)."""
        slots = self._templates[tenant_id]
        bits = (feats > 0.0).astype(np.float32)
        # dedupe: a tick batches several misses of the SAME prompt (each
        # matched before any was admitted); admitting each would write
        # identical rows whose tied margin (0) escalates every later exact
        # match forever. Refresh the existing row's response instead.
        dup = np.flatnonzero(slots.valid & (slots.bits == bits).all(axis=1))
        if dup.size:
            row = int(dup[0])
            self._store.put((tenant_id, row), tokens)
            return row
        free = np.flatnonzero(~slots.valid)
        if free.size:
            row = int(free[0])
        else:
            row = self._store.oldest_row(tenant_id)
            if row is None:  # unreachable under the store invariant
                row = 0
            self.obs.record_cache_event("evict")
        slots.bits[row] = bits
        slots.valid[row] = True
        dirty = {tenant_id}
        for etid, erow in self._store.put((tenant_id, row), tokens):
            esl = self._templates.get(etid)
            if esl is not None and esl.valid[erow]:
                esl.valid[erow] = False
                esl.bits[erow] = 0.0
                dirty.add(etid)
                self.obs.record_cache_event("evict")
        for tid in dirty:
            self._sync_bank(tid)
        self.obs.record_cache_event("insert")
        return row

    # -- response assembly --------------------------------------------------

    def collect_routed(self,
                       responses: list[ClassifyResponse]
                       ) -> list[RoutedResponse]:
        """Fold classify responses back onto their prompt jobs: hits read
        the response store (LRU-refreshing), misses take the fresh decode.
        Non-prompt responses (classify traffic sharing the service) pass
        through untouched by this method — route them normally."""
        out: list[RoutedResponse] = []
        for resp in responses:
            job = self._jobs.pop(resp.request_id, None)
            if job is None:
                continue
            tokens = self._decoded.pop(resp.request_id, None)
            self._decode_j.pop(resp.request_id, None)
            base = dict(request_id=resp.request_id,
                        tenant_id=resp.tenant_id, margin=resp.margin,
                        score=resp.score, energy_j=resp.energy_j,
                        latency_s=resp.latency_s)
            if resp.error is not None:
                out.append(RoutedResponse(tokens=(), cache_hit=False,
                                          template_id=-1, error=resp.error,
                                          **base))
                continue
            if resp.escalated:
                self.obs.record_cache_event("miss")
                self.obs.record_cache_latency(False, resp.latency_s)
                out.append(RoutedResponse(tokens=tokens, cache_hit=False,
                                          template_id=resp.pred, **base))
                continue
            stored = self._store.get((resp.tenant_id, resp.pred))
            if stored is None:  # store invariant breach — answer honestly
                out.append(RoutedResponse(
                    tokens=(), cache_hit=False, template_id=resp.pred,
                    error="matched template has no stored response",
                    **base))
                continue
            self.obs.record_cache_event("hit")
            self.obs.record_cache_latency(True, resp.latency_s)
            out.append(RoutedResponse(tokens=stored, cache_hit=True,
                                      template_id=resp.pred, **base))
        return out

    def step_routed(self) -> list[RoutedResponse]:
        """One scheduler tick, returned as routed LM responses."""
        return self.collect_routed(self.step())

    def serve_prompts(self,
                      requests: Iterable[PromptRequest]
                      ) -> list[RoutedResponse]:
        """Submit a burst of prompts and run ticks until the queue drains
        (admission order == service order; the replayed-trace idiom the
        bit-identity tests assert on)."""
        for req in requests:
            self.submit_prompt(req)
        out: list[RoutedResponse] = []
        while self.scheduler.qsize:
            out.extend(self.step_routed())
        return out

    # -- durability ---------------------------------------------------------

    def _extra_snapshot_state(self) -> dict:
        """Router state riding the service snapshot: the response store in
        LRU order (token tuples are exact ints — bit-identical round-trip)
        and the cache-tenant set. Template bits/validity are NOT
        duplicated: the registry arrays in the same snapshot already hold
        those bytes, and `_adopt_snapshot_state` reads them back."""
        return {"router": {
            "store": self._store.state(),
            "tenants": sorted(self._templates),
        }}

    def _adopt_snapshot_state(self, extra: dict) -> None:
        router = (extra or {}).get("router")
        if not router:
            return
        self._store.load_state(router["store"])
        for tid in router["tenants"]:
            bank = self.registry.bank_of(tid)
            self._templates[tid] = _TemplateSlots(
                bits=np.asarray(bank.templates[:, 0], np.float32).copy(),
                valid=np.asarray(bank.valid[:, 0], bool).copy())

    @classmethod
    def restore(cls, ckpt, step: int | None = None, *, device=None,
                engine: engine_lib.Engine | None = None, featurizer=None):
        """`HybridService.restore` + router re-attachment, on ``device``. A
        snapshot written by either package restores here. The engine is
        never serialised: pass it back in (or later via `attach_backend`);
        hits serve with no engine at all."""
        svc, report = super().restore(ckpt, step, device=device)
        svc.attach_backend(engine, featurizer=featurizer)
        return svc, report


def synthetic_prompt_trace(seed: int, *, vocab: int, n_unique: int,
                           n_requests: int, min_len: int = 8,
                           max_len: int = 16,
                           zipf_a: float = 1.2) -> list[np.ndarray]:
    """Deterministic Zipf-repeat prompt trace for benches/examples: the
    first ``n_unique`` requests are the distinct prompts (all cold
    misses), the remaining ``n_requests - n_unique`` replay them with
    Zipf(a) popularity — so a bank holding ``n_unique`` templates serves
    exactly ``1 - n_unique/n_requests`` of the trace from cache."""
    if not 1 <= n_unique <= n_requests:
        raise ValueError(f"need 1 <= n_unique <= n_requests, got "
                         f"{n_unique}/{n_requests}")
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(n_unique):
        length = int(rng.integers(min_len, max_len + 1))
        pool.append(rng.integers(0, vocab, size=length).astype(np.int32))
    weights = 1.0 / np.arange(1, n_unique + 1, dtype=np.float64) ** zipf_a
    weights /= weights.sum()
    trace = list(pool)
    repeats = rng.choice(n_unique, size=n_requests - n_unique, p=weights)
    trace += [pool[i] for i in repeats]
    return trace
