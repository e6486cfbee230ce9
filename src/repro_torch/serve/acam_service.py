"""Multi-tenant ACAM classification service (the hybrid cascade core).

Built from ONE `repro_torch.serve.spec.ServiceSpec` (the front door is
`repro_torch.serve.control.HybridService.from_spec`):

    submit -> admission (known tenant, feature dim, queue bound)
           -> micro-batching scheduler (ONE engine call per tick over the
              registry's super-bank: one `acam_match_serve` kernel, or one
              kernel a tile under a sharded mesh)
           -> confidence cascade: the per-request Eq. 12 winner-vs-runner-up
              **margin** decides
                accept-at-ACAM   (margin >= tau): charge E_backend only
                escalate         (margin <  tau): run the tenant's CNN
                                 logits head on the same features; charge
                                 E_frontend + E_backend (paper §V-D via
                                 `repro_torch.core.energy`)
           -> per-request `ClassifyResponse` + aggregated service metrics.

Every number the service reports lives in its `repro_torch.obs.
FlightRecorder` (`self.obs`); `metrics()` and `health()` read it. A tick's
escalated slots are coalesced into one dense-head call (`torch.einsum`,
padded to power-of-two buckets). Tenants without a head never escalate.
Requests past ``cascade.deadline_ms`` expire with an error; an overloaded
tick (``shed_queue`` / ``shed_p99_ms``) answers from the ACAM stage alone.

`make_synthetic_tenant` / `sample_tenant_queries` build deterministic
per-tenant banks + nearest-centroid heads without training a CNN.

``ACAMService(num_features, config=ServiceConfig(...))`` is the JAX
package's deprecated keyword constructor, bridged onto a spec by
`repro_torch.serve.spec.from_legacy`; ``ACAMService(spec)`` takes a spec.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch.core import energy as energy_lib
from repro_torch.core import templates
from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve
from repro_torch.obs import FlightRecorder
from repro_torch.serve.registry import RegistryError, TemplateBankRegistry
from repro_torch.serve.scheduler import (MicroBatchScheduler, SchedulerStats,
                                         SlotResult, WorkItem)


class AdmissionError(ValueError):
    """Request rejected at admission (unknown tenant, bad shape, overload)."""


@dataclasses.dataclass(frozen=True)
class ClassifyRequest:
    """One classification request: a tenant's raw front-end feature map."""

    tenant_id: str
    features: np.ndarray  # (N,) float32


@dataclasses.dataclass
class ClassifyResponse:
    request_id: int
    tenant_id: str
    pred: int  # tenant-local class id; -1 on error
    margin: float  # Eq. 12 confidence margin at the ACAM
    escalated: bool  # False: accepted at the ACAM back-end
    energy_j: float  # E_backend, or E_frontend + E_backend if escalated
    latency_s: float  # submit -> response wall time
    error: str | None = None  # e.g. tenant evicted while the request queued
    #: True: the margin asked for escalation but load-shed mode served the
    #: ACAM winner instead
    shed: bool = False
    #: winner's absolute per-class score in native units (0 on error)
    score: float = 0.0


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """The deprecated constructor's knobs (`spec.from_legacy` maps them)."""

    slots: int = 64  # scheduler micro-batch size
    method: str = "feature_count"
    alpha: float = 1.0
    #: cascade accept threshold in match-count units (0..N); the spec
    #: rescales it for backends whose margins are fractions
    margin_tau: float = 8.0
    max_queue: int = 4096  # admission bound
    # paper §V-D energy attribution (repro_torch.core.energy defaults)
    frontend_macs: int = 23_785_120
    frontend_sparsity: float = 0.80
    softmax_head_ops: int = 7_850
    paper_faithful: bool = True


@dataclasses.dataclass
class _TenantRuntime:
    has_head: bool  # False: cascade disabled (no escalation target)
    raw_tau: float | None  # per-tenant override in the spec's tau_units
    margin_tau: float | None  # resolved to native units; None: no head
    backend_j: float  # Eq. 14 energy of this tenant's programmed rows


def _bucket(n: int, cap: int) -> int:
    """Next power-of-two >= n, capped (escalation batch shape buckets)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def _escalate_heads(w_table: torch.Tensor, b_table: torch.Tensor,
                    feats: torch.Tensor, head_slot: torch.Tensor,
                    n_classes: torch.Tensor) -> torch.Tensor:
    """One dense-head call for all escalated slots of a tick: gather each
    slot's tenant head, mask class columns past its true class count."""
    w = w_table[head_slot]  # (S, N, C)
    b = b_table[head_slot]  # (S, C)
    logits = torch.einsum("sn,snc->sc", feats, w) + b
    cols = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    logits = torch.where(cols < n_classes[:, None], logits,
                         torch.tensor(float("-inf"), device=logits.device))
    return torch.argmax(logits, dim=-1).to(torch.int32)


class ACAMService:
    """Request/response front for multi-tenant hybrid ACAM classification,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, spec, *, config: ServiceConfig | None = None,
                 k_max: int = 2, class_bucket: int = 16,
                 backend: str | None = None, bank_shards: int | None = None,
                 device=None):
        """``ACAMService(spec)``, or the deprecated keyword form
        ``ACAMService(num_features, config=ServiceConfig(...), k_max=...,
        class_bucket=..., backend=..., bank_shards=...)``, bridged onto a
        spec by `repro_torch.serve.spec.from_legacy` (prefer
        `HybridService.from_spec`).

        ``bank_shards`` aligns the registry's tenant placement to the bank
        shards the engine's `PartitionPlan` cuts the super-bank into. None
        infers it from the installed mesh, and warns when none is
        installed: it then resolves to 1, which is the ordering trap this
        constructor is deprecated for (`from_spec` installs the mesh
        first)."""
        from repro_torch.serve import spec as spec_lib

        if not isinstance(spec, spec_lib.ServiceSpec):
            if bank_shards is None:
                from repro_torch.distributed import context
                from repro_torch.match import plan as plan_lib

                if context.get_mesh() is None:
                    warnings.warn(
                        "ACAMService(bank_shards=None) with no mesh "
                        "installed: bank_shards silently resolves to 1. "
                        "Install the serving mesh BEFORE constructing the "
                        "service to shard the super-bank, or use the spec "
                        "path (repro_torch.serve.control.HybridService."
                        "from_spec), which installs it itself.",
                        UserWarning, stacklevel=2)
                bank_shards = plan_lib.bank_shards_in_mesh()
            spec = spec_lib.from_legacy(
                int(spec), config=config, k_max=k_max,
                class_bucket=class_bucket, backend=backend,
                bank_shards=bank_shards)
        self._build(spec, resolve(device))

    def _build(self, spec, device: torch.device) -> None:
        """Construct every tier from a validated `ServiceSpec`: registry ->
        scheduler -> cascade."""
        spec.validate()
        self.spec = spec
        self.device = device
        self.obs = FlightRecorder(spec.obs)
        self.registry = TemplateBankRegistry(
            spec.registry.num_features, k_max=spec.registry.k_max,
            class_bucket=spec.registry.class_bucket,
            initial_classes=spec.registry.initial_classes,
            initial_tenants=spec.registry.initial_tenants,
            bank_shards=spec.mesh.bank_shards, device=device)
        self.scheduler = MicroBatchScheduler(
            self.registry, slots=spec.scheduler.slots, engine=spec.engine,
            recorder=self.obs)
        # the cascade's tau rides into the serve kernel: the margin < tau
        # compare happens in the tick's kernel call (SlotResult.escalate)
        self.scheduler.tau_fn = self._margin_tau_of
        self.scheduler.monitor.sink = self.obs.record_straggler
        self.obs.slots_gauge.set(spec.scheduler.slots)
        #: control-plane failure state (a simulated device loss): None =
        #: every device of `context.devices()` is healthy; else the
        #: surviving list every mesh (re)install is built over
        #: (`HybridService.handle_device_loss`)
        self._devices = None
        self._lost_devices: set[int] = set()
        self._healthy_spec = spec  # the spec in force before any loss
        self._tenants: dict[str, _TenantRuntime] = {}
        self._head_w: np.ndarray | None = None  # (T_cap, N, C_head)
        self._head_b: np.ndarray | None = None  # (T_cap, C_head)
        self._head_cache: tuple[int, torch.Tensor, torch.Tensor] | None = None
        self._head_gen = 0
        self._next_id = 0
        self._apply_cascade(spec)

    def _apply_cascade(self, spec) -> None:
        """(Re)derive what the cascade spec controls: tau unit conversion,
        the §V-D front-end energy, every tenant's resolved threshold."""
        casc = spec.cascade
        self.spec = spec
        self.config = ServiceConfig(
            slots=spec.scheduler.slots, method=spec.engine.method,
            alpha=spec.engine.alpha, margin_tau=casc.tau,
            max_queue=casc.max_queue, frontend_macs=casc.frontend_macs,
            frontend_sparsity=casc.frontend_sparsity,
            softmax_head_ops=casc.softmax_head_ops,
            paper_faithful=casc.paper_faithful)
        self._tau_scale = spec.tau_scale()
        effective = int(round(casc.frontend_macs
                              * (1.0 - casc.frontend_sparsity)))
        effective -= casc.softmax_head_ops
        self._frontend_j = energy_lib.frontend_energy(
            effective, paper_faithful=casc.paper_faithful)
        for rt in self._tenants.values():
            rt.margin_tau = self._resolve_tau(rt.raw_tau) if rt.has_head \
                else None

    def _resolve_tau(self, raw: float | None) -> float:
        """Spec-units tau (per-tenant override or the cascade default) ->
        the served backend's native margin units."""
        tau = self.spec.cascade.tau if raw is None else raw
        return tau * self._tau_scale

    def _margin_tau_of(self, tenant_id: str) -> float | None:
        """The scheduler's `tau_fn` (None = no head, never escalate)."""
        rt = self._tenants.get(tenant_id)
        return None if rt is None else rt.margin_tau

    # -- tenant lifecycle ---------------------------------------------------

    def register_tenant(self, tenant_id: str, bank: TemplateBank, *,
                        head: tuple[np.ndarray, np.ndarray] | None = None,
                        margin_tau: float | None = None) -> None:
        """Hot-register a tenant: templates into the super-bank, optional
        (W (N, C), b (C,)) CNN logits head enabling the escalation path."""
        head = self._check_head(head)  # validate BEFORE mutating the registry
        entry = self.registry.register(tenant_id, bank)
        self._install(tenant_id, entry.slot, entry.valid_rows, head,
                      margin_tau)

    def update_tenant(self, tenant_id: str, bank: TemplateBank, *,
                      head: tuple[np.ndarray, np.ndarray] | None = None,
                      margin_tau: float | None = None) -> None:
        head = self._check_head(head)
        entry = self.registry.update(tenant_id, bank)
        self._install(tenant_id, entry.slot, entry.valid_rows, head,
                      margin_tau)

    def evict_tenant(self, tenant_id: str) -> None:
        self.registry.evict(tenant_id)
        del self._tenants[tenant_id]

    def retune_tenant(self, tenant_id: str, *,
                      margin_tau: float | None) -> None:
        """Change ONLY a tenant's cascade threshold (spec tau_units; None
        reverts to the cascade default)."""
        rt = self._tenants[tenant_id]
        rt.raw_tau = margin_tau
        rt.margin_tau = self._resolve_tau(margin_tau) if rt.has_head \
            else None

    def _check_head(self, head):
        if head is None:
            return None
        w = np.asarray(head[0], np.float32)
        b = np.asarray(head[1], np.float32)
        if w.shape[0] != self.registry.num_features:
            raise RegistryError(
                f"head expects {w.shape[0]} features, registry serves "
                f"{self.registry.num_features}")
        if w.shape[1] != b.shape[0]:
            raise RegistryError(
                f"head shapes disagree: W {w.shape} vs b {b.shape}")
        return w, b

    def _install(self, tenant_id, slot, valid_rows, head, margin_tau):
        if head is not None:
            self._head_store(slot, head[0], head[1])
        self._tenants[tenant_id] = _TenantRuntime(
            has_head=head is not None, raw_tau=margin_tau,
            margin_tau=self._resolve_tau(margin_tau)
            if head is not None else None,
            backend_j=energy_lib.backend_energy(valid_rows,
                                                self.registry.num_features))

    def head_of(self, tenant_id: str) -> tuple[np.ndarray, np.ndarray]:
        """The tenant's (W (N, C), b (C,)) escalation head."""
        entry = self.registry.get(tenant_id)
        c = entry.num_classes
        if self._head_w is None or not self._tenants[tenant_id].has_head:
            raise RegistryError(f"tenant {tenant_id!r} has no head")
        return (self._head_w[entry.slot, :, :c].copy(),
                self._head_b[entry.slot, :c].copy())

    def _head_store(self, slot: int, w: np.ndarray, b: np.ndarray) -> None:
        t_cap = self.registry.capacity_tenants
        n = self.registry.num_features
        c = w.shape[1]
        c_head = c if self._head_w is None else \
            max(c, self._head_w.shape[-1])
        if (self._head_w is None or self._head_w.shape[0] < t_cap
                or self._head_w.shape[-1] < c_head):
            new_w = np.zeros((t_cap, n, c_head), np.float32)
            new_b = np.full((t_cap, c_head), -np.inf, np.float32)
            if self._head_w is not None:
                ow, ob = self._head_w, self._head_b
                new_w[:ow.shape[0], :, :ow.shape[-1]] = ow
                new_b[:ob.shape[0], :ob.shape[-1]] = ob
            self._head_w, self._head_b = new_w, new_b
        self._head_w[slot, :, :c] = w
        self._head_w[slot, :, c:] = 0.0
        self._head_b[slot, :c] = b
        self._head_b[slot, c:] = -np.inf
        self._head_gen += 1
        self._head_cache = None

    def _head_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._head_cache is None or self._head_cache[0] != self._head_gen:
            self._head_cache = (
                self._head_gen,
                torch.tensor(self._head_w, device=self.device),
                torch.tensor(self._head_b, device=self.device))
        return self._head_cache[1], self._head_cache[2]

    # -- request path -------------------------------------------------------

    def submit(self, request: ClassifyRequest) -> int:
        """Admit one request into the scheduler queue; returns request id."""
        if request.tenant_id not in self.registry:
            self.obs.record_rejected()
            raise AdmissionError(f"unknown tenant {request.tenant_id!r}")
        feats = np.asarray(request.features, np.float32).reshape(-1)
        if feats.shape[0] != self.registry.num_features:
            self.obs.record_rejected()
            raise AdmissionError(
                f"expected {self.registry.num_features} features, got "
                f"{feats.shape[0]}")
        max_queue = self.spec.cascade.max_queue
        if self.scheduler.qsize >= max_queue:
            self.obs.record_rejected()
            raise AdmissionError(f"queue full ({max_queue} pending)")
        self._next_id += 1
        t_admit = time.perf_counter()
        self.scheduler.submit(WorkItem(
            request_id=self._next_id, tenant_id=request.tenant_id,
            features=feats, submit_t=t_admit))
        self.obs.record_submit(self._next_id, request.tenant_id, t_admit)
        self.obs.set_queue_depth(self.scheduler.qsize)
        return self._next_id

    def overloaded(self) -> bool:
        """True when the queue has reached ``cascade.shed_queue`` or the
        rolling p99 latency exceeds ``cascade.shed_p99_ms``: the next tick
        then answers from the ACAM stage alone."""
        casc = self.spec.cascade
        if casc.shed_queue is not None \
                and self.scheduler.qsize >= casc.shed_queue:
            return True
        if casc.shed_p99_ms is not None \
                and self.obs.latency.window_count >= 32 \
                and self.obs.latency_quantile_ms(0.99) > casc.shed_p99_ms:
            return True
        return False

    def step(self) -> list[ClassifyResponse]:
        """One scheduler tick + the cascade over its results (expired
        requests first; an overloaded tick sheds escalation)."""
        t0 = time.perf_counter()
        responses: list[ClassifyResponse] = []
        casc = self.spec.cascade
        if casc.deadline_ms is not None:
            for item in self.scheduler.expire(casc.deadline_ms / 1e3):
                responses.append(ClassifyResponse(
                    request_id=item.request_id, tenant_id=item.tenant_id,
                    pred=-1, margin=0.0, escalated=False, energy_j=0.0,
                    latency_s=time.perf_counter() - item.submit_t,
                    error=f"deadline exceeded ({casc.deadline_ms} ms "
                          "in queue)"))
        n_expired = len(responses)
        shedding = self.overloaded()
        self.obs.set_shed_mode(shedding, queue_depth=self.scheduler.qsize)
        results = self.scheduler.tick()
        if not results:
            if responses:
                self._finalize_step(responses, t0, shedding, fill=0,
                                    n_expired=n_expired, dispatched=False,
                                    escalation=False, frontend={})
            return responses
        if shedding:
            self.obs.record_shed_tick()
        escalate: list[SlotResult] = []
        keep: list[tuple[SlotResult, bool, bool]] = []
        for r in results:
            rt = self._tenants.get(r.item.tenant_id) if r.error is None \
                else None
            # the margin < tau compare ran in the tick's kernel call;
            # _wants_escalation is the routing-policy hook (the semantic
            # cache adds its absolute hit-score floor)
            wants = rt is not None and self._wants_escalation(r)
            if wants and not shedding:
                escalate.append(r)
                keep.append((r, True, False))
            else:
                keep.append((r, False, wants))

        esc_pred: dict[int, int] = {}
        if escalate:
            esc_pred = self._run_escalation(escalate)

        now = time.perf_counter()
        fcost: dict[int, float] = {}
        for r, escalated, shed in keep:
            if r.error is not None:
                responses.append(ClassifyResponse(
                    request_id=r.item.request_id,
                    tenant_id=r.item.tenant_id, pred=-1, margin=0.0,
                    escalated=False, energy_j=0.0,
                    latency_s=now - r.item.submit_t, error=r.error))
                continue
            rt = self._tenants[r.item.tenant_id]
            pred = esc_pred[r.item.request_id] if escalated else r.pred_local
            fj = self._frontend_cost(r.item.request_id) if escalated \
                else 0.0
            fcost[r.item.request_id] = fj
            responses.append(ClassifyResponse(
                request_id=r.item.request_id,
                tenant_id=r.item.tenant_id, pred=pred,
                margin=r.margin, escalated=escalated,
                energy_j=rt.backend_j + fj,
                latency_s=now - r.item.submit_t, shed=shed,
                score=r.score))
        self._finalize_step(responses, t0, shedding, fill=len(results),
                            n_expired=n_expired, dispatched=True,
                            escalation=bool(escalate), now=now,
                            frontend=fcost)
        return responses

    def _finalize_step(self, responses: list[ClassifyResponse], t0: float,
                       shedding: bool, *, fill: int, n_expired: int,
                       dispatched: bool, escalation: bool,
                       frontend: dict[int, float],
                       now: float | None = None) -> None:
        """Book one step into the flight recorder (pure accounting: the
        answers are fixed before this runs). ``frontend`` holds each
        request's escalation energy, where the step charged one."""
        obs = self.obs
        if escalation:
            obs.record_escalation_dispatch()
        for r in responses:
            if r.error is not None:
                obs.finish_request(r, 0.0, 0.0)
            else:
                rt = self._tenants[r.tenant_id]
                obs.finish_request(r, rt.backend_j,
                                   frontend.get(r.request_id, 0.0))
        now = time.perf_counter() if now is None else now
        obs.add_busy(now - t0)
        obs.set_queue_depth(self.scheduler.qsize)
        if obs.events.enabled:
            obs.emit(
                "tick",
                tick_id=obs.tick_seq - 1 if dispatched else -1,
                fill=fill,
                served=sum(r.error is None for r in responses),
                escalated=sum(r.escalated for r in responses),
                shed=sum(r.shed for r in responses),
                expired=n_expired,
                dt_ms=round(obs.last_dispatch_ms, 4) if dispatched else 0.0,
                queue_depth=self.scheduler.qsize,
                shed_mode=int(shedding),
                energy_j=sum(r.energy_j for r in responses))

    def _wants_escalation(self, r: SlotResult) -> bool:
        """Routing-policy hook: should this served slot escalate? The base
        cascade trusts the tick's ``margin < tau`` bit; the semantic cache
        (`repro_torch.serve.semantic_cache`) adds its hit-score floor."""
        return r.escalate

    def _frontend_cost(self, request_id: int) -> float:
        """Energy charged for ONE escalated request: the §V-D CNN head's
        figure here; the semantic cache charges the request's decode."""
        del request_id
        return self._frontend_j

    def _run_escalation(self, escalate: list[SlotResult]) -> dict[int, int]:
        """Coalesce a tick's escalated slots into one dense-head call."""
        n = self.registry.num_features
        size = _bucket(len(escalate), self.spec.scheduler.slots)
        feats = np.zeros((size, n), np.float32)
        slot = np.zeros((size,), np.int64)
        ncls = np.ones((size,), np.int64)
        for i, r in enumerate(escalate):
            feats[i] = r.item.features
            slot[i] = r.entry.slot
            ncls[i] = r.entry.num_classes
        w_table, b_table = self._head_tables()
        dev = self.device
        pred = _escalate_heads(w_table, b_table,
                               torch.from_numpy(feats).to(dev),
                               torch.from_numpy(slot).to(dev),
                               torch.from_numpy(ncls).to(dev)).cpu().numpy()
        return {r.item.request_id: int(pred[i])
                for i, r in enumerate(escalate)}

    def drain(self) -> list[ClassifyResponse]:
        """Run ticks until the queue empties."""
        out: list[ClassifyResponse] = []
        while self.scheduler.qsize:
            out.extend(self.step())
        return out

    def serve(self, requests: list[ClassifyRequest]) -> list[ClassifyResponse]:
        """Submit a burst and run ticks until the queue drains."""
        for req in requests:
            self.submit(req)
        return self.drain()

    def metrics(self) -> dict:
        """The service's aggregate view, read from the flight recorder."""
        o = self.obs
        completed = int(o.responses.total())
        done = max(completed, 1)
        escalated = int(o.responses.value(disposition="escalated"))
        shed = int(o.responses.value(disposition="shed"))
        failed = int(o.responses.value(disposition="expired")
                     + o.responses.value(disposition="error"))
        busy = o.busy_seconds.value()
        ticks = int(o.ticks.value())
        slots = self.scheduler.slots
        energy_j = o.ledger.fleet_j()
        return {
            "submitted": int(o.submitted.value()),
            "completed": completed,
            "rejected": int(o.rejected.value()),
            "failed": failed,
            "escalated": escalated,
            "escalation_rate": round(escalated / done, 4),
            "shed": shed,
            "shed_rate": round(shed / done, 4),
            "load_shed_ticks": int(o.load_shed_ticks.value()),
            "escalation_dispatches": int(o.esc_dispatches.value()),
            "requests_per_s": round(completed / busy, 2) if busy else 0.0,
            "latency_p50_ms": round(o.latency_quantile_ms(0.50), 3),
            "latency_p99_ms": round(o.latency_quantile_ms(0.99), 3),
            "energy_total_j": energy_j,
            "nj_per_request": round(energy_j / done * 1e9, 4),
            "ticks": ticks,
            "classify_dispatches": int(o.dispatches.value()),
            "served": int(o.served.value()),
            "occupancy": round(o.filled_slots.value() / (ticks * slots), 4)
            if ticks else 0.0,
            "min_fill": int(o.fill_min.value()),
            "max_fill": int(o.fill_max.value()),
            "slots": slots,
            "tick_time_s": round(o.tick_seconds.value(), 6),
            "slow_ticks": int(o.slow_ticks.value()),
            "expired": int(o.expired.value()),
        }

    def health(self) -> dict:
        """Liveness view for operators and the fleet controller: straggler
        strikes, queue depth, load-shed state, and the autoscaling policy's
        inputs (`repro_torch.fleet.policy.view_of` reads only this):
        per-shard registered rows against capacity, the fused row count
        against its budget, rolling fill, p99 and the energy split."""
        from repro_torch.kernels import layout
        from repro_torch.match.backends import MAX_FUSED_ROWS

        verdict = self.scheduler.last_verdict or {}
        stats = self.registry.stats()
        rows = self.registry.rows_per_shard
        return {
            "queue_depth": self.scheduler.qsize,
            "load_shedding": self.overloaded(),
            "slow_ticks": int(self.obs.slow_ticks.value()),
            "straggler_strikes": {
                int(labels["host"]): int(v)
                for labels, v in self.obs.straggler_strikes.items()},
            "evict_verdict": list(verdict.get("evict", ())),
            "tenants": stats["tenants"],
            "bank_shards": stats["bank_shards"],
            "capacity_classes": stats["capacity_classes"],
            "rows_per_shard": rows,
            "shard_rows_used": self.registry.shard_rows_used(),
            "fused_rows_per_shard":
                self.registry.k_max * layout.padded_classes(rows),
            # the name is the JAX package's (its resident serve kernel
            # holds these rows in TPU VMEM); MAX_FUSED_ROWS is still that
            # TPU rule, not a number measured on the card
            "vmem_budget_rows": MAX_FUSED_ROWS,
            "rolling_batch_fill": round(self.obs.rolling_batch_fill(), 3),
            "slots": self.scheduler.slots,
            # the mesh devices the service may build over (survivors after
            # a device loss)
            "devices": self._device_count(),
            "device": str(self.device),
            "p99_ms": round(self.obs.latency_quantile_ms(0.99), 4),
            "energy_backend_j": self.obs.ledger.backend_j(),
            "energy_frontend_j": self.obs.ledger.frontend_j(),
        }

    def _device_count(self) -> int:
        from repro_torch.distributed import context

        if self._devices is not None:
            return len(self._devices)
        return len(context.devices(self.device))

    def reset_metrics(self) -> None:
        """Zero the run counters (e.g. after a warmup burst); gauges, the
        latency histogram's rolling window, span conservation totals, the
        tick-id sequence and the event log survive
        (`repro_torch.obs.FlightRecorder.reset`)."""
        self.obs.reset()
        self.scheduler.stats = SchedulerStats(slots=self.scheduler.slots)


# ---------------------------------------------------------------------------
# Synthetic tenants (launcher / benchmark / test fixtures)
# ---------------------------------------------------------------------------

def make_synthetic_tenant(
    seed: int, *, num_classes: int = 10, k: int = 1, num_features: int = 64,
    samples_per_class: int = 24, spread: float = 0.6,
) -> tuple[TemplateBank, tuple[np.ndarray, np.ndarray], np.ndarray]:
    """A deterministic per-tenant classifier without training a CNN: class
    prototypes, a `TemplateBank` fitted (on the CPU) to noisy samples around
    them, and the matching nearest-centroid dense head
    ``logits_c = f . p_c - |p_c|^2 / 2``.

    Returns (bank, (head_w (N, C), head_b (C,)), prototypes (C, N)).
    """
    rng = np.random.RandomState(seed)
    protos = rng.randn(num_classes, num_features).astype(np.float32)
    n = num_classes * samples_per_class
    labels = np.repeat(np.arange(num_classes, dtype=np.int32),
                       samples_per_class)
    feats = protos[labels] + spread * rng.randn(n, num_features).astype(
        np.float32)
    bank = templates.generate_templates(
        torch.from_numpy(feats), torch.from_numpy(labels), num_classes, k=k)
    head_w = protos.T.astype(np.float32)  # (N, C)
    head_b = (-0.5 * np.sum(protos**2, axis=1)).astype(np.float32)
    return bank, (head_w, head_b), protos


def sample_tenant_queries(
    seed: int, protos: np.ndarray, n: int, *, noise: float = 0.8,
) -> tuple[np.ndarray, np.ndarray]:
    """Draw n query feature maps around a tenant's prototypes.
    Returns (features (n, N), labels (n,))."""
    rng = np.random.RandomState(seed)
    num_classes, num_features = protos.shape
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    feats = protos[labels] + noise * rng.randn(n, num_features).astype(
        np.float32)
    return feats.astype(np.float32), labels
