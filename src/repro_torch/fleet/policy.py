"""The autoscaling policy: a pure function from telemetry to the next spec.

A twin of the JAX package's `repro/fleet/policy.py`. `RegistryView` is a
FROZEN snapshot of the controller's inputs (per-shard registered rows
against capacity, the fused row budget, queue depth, the rolling p99 and
batch fill, the §V-D energy ledger's backend/frontend split), built only
from `service.health()` and the spec in force.

`decide(view, policy) -> ServiceSpec` is pure and deterministic. One
evaluation proposes at most ONE transition, in fixed priority order:

  1. **escalate `bank_shards`** when the fullest shard's registered rows
     approach its row budget, or the per-shard fused row count approaches
     `MAX_FUSED_ROWS`. With ``mesh.install`` set the new count must
     divide the available devices (`_shards_allowed`: on one card that
     takes a forced mesh); the `Autopilot` executes it through the
     double-buffered rolling reshard.
  2. **swap kernel -> device backend** when the ledger says E_backend
     dominates fleet energy (per-shard programming noise forced, as in the
     JAX package).
  3. **widen scheduler slots** under sustained batch-fill saturation: the
     rolling mean fill sits at the slot count AND a queue has formed.

`should_compact(view, policy)` is the separate reclaim signal: occupancy
below the threshold means `registry.compact()` would give rows back.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.serve.spec import ServiceSpec


class PolicySpec(NamedTuple):
    """Controller thresholds + the autopilot's cadence knobs."""

    # rule 1: shard escalation
    shard_rows_frac: float = 0.75  # fullest shard used/capacity trigger
    vmem_rows_frac: float = 1.0  # fused rows / MAX_FUSED_ROWS trigger
    max_bank_shards: int = 8
    # rule 2: backend swap (kernel -> device)
    backend_energy_frac: float = 0.9  # E_backend share of fleet energy
    min_energy_j: float = 0.0  # ignore the ledger below this total
    # rule 3: slot widening
    widen_fill_frac: float = 0.95  # rolling fill / slots trigger
    widen_queue_factor: float = 2.0  # AND queue_depth >= factor * slots
    max_slots: int = 256
    # compaction
    compact_below: float = 0.5  # used rows / capacity
    # autopilot cadence (impure half, carried here so ONE value object
    # describes the whole controller)
    interval: int = 8  # evaluate every K observed ticks
    hysteresis: int = 2  # consecutive identical proposals before acting
    cooldown: int = 64  # observed ticks to hold after any action


class RegistryView(NamedTuple):
    """Frozen controller input: the spec in force + the health() fields.
    Hashable (shard_rows_used is a tuple), so views key caches and diff
    cleanly; JSON-round-trippable (`to_dict`/`from_dict`) so every logged
    `policy_decision` carries the exact view it decided from."""

    spec: ServiceSpec
    tenants: int = 0
    shard_rows_used: tuple = ()  # allocated class rows per shard
    rows_per_shard: int = 0
    capacity_classes: int = 0
    fused_rows_per_shard: int = 0  # k_max * padded(rows_per_shard)
    vmem_budget_rows: int = 0  # repro_torch.match MAX_FUSED_ROWS
    queue_depth: int = 0
    p99_ms: float = 0.0
    rolling_fill: float = 0.0  # mean batch fill over the rolling window
    slots: int = 0
    devices: int = 1
    backend_j: float = 0.0  # ledger: fleet ACAM-stage joules
    frontend_j: float = 0.0  # ledger: fleet CNN/decode-stage joules

    def to_dict(self) -> dict:
        d = self._asdict()
        d["spec"] = self.spec.to_dict()
        d["shard_rows_used"] = list(self.shard_rows_used)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RegistryView":
        d = dict(d)
        d["spec"] = ServiceSpec.from_dict(d["spec"])
        d["shard_rows_used"] = tuple(int(x) for x in d["shard_rows_used"])
        return cls(**d)


def view_of(service) -> RegistryView:
    """Snapshot a live service into a frozen `RegistryView` — reads ONLY
    `service.health()` (satellite contract: the controller's inputs are
    first-class health fields) and the public spec."""
    h = service.health()
    return RegistryView(
        spec=service.spec,
        tenants=h["tenants"],
        shard_rows_used=tuple(h["shard_rows_used"]),
        rows_per_shard=h["rows_per_shard"],
        capacity_classes=h["capacity_classes"],
        fused_rows_per_shard=h["fused_rows_per_shard"],
        vmem_budget_rows=h["vmem_budget_rows"],
        queue_depth=h["queue_depth"],
        p99_ms=h["p99_ms"],
        rolling_fill=h["rolling_batch_fill"],
        slots=h["slots"],
        devices=h["devices"],
        backend_j=h["energy_backend_j"],
        frontend_j=h["energy_frontend_j"])


def _shards_allowed(view: RegistryView, shards: int) -> bool:
    """Can the fleet actually form a ``shards``-wide model axis?"""
    if view.spec.mesh.install:
        return view.devices % shards == 0 and shards <= view.devices
    return True  # no installed mesh: replicated execution, any count packs


def explain(view: RegistryView,
            policy: PolicySpec = PolicySpec()) -> tuple[str, str,
                                                        ServiceSpec]:
    """`decide` plus the why: ``(action, reason, next_spec)``. ``action``
    is "hold" when the spec should stand. Pure — see module docstring."""
    spec = view.spec

    # 1. shard escalation: capacity or VMEM pressure on the fullest shard
    if view.tenants and view.rows_per_shard:
        hot = max(view.shard_rows_used) / view.rows_per_shard
        vmem = (view.fused_rows_per_shard / view.vmem_budget_rows
                if view.vmem_budget_rows else 0.0)
        if hot >= policy.shard_rows_frac or vmem >= policy.vmem_rows_frac:
            shards = spec.mesh.bank_shards * 2
            if shards <= policy.max_bank_shards \
                    and _shards_allowed(view, shards):
                align = shards * spec.registry.class_bucket
                initial = -(-spec.registry.initial_classes // align) * align
                target = spec._replace(
                    mesh=spec.mesh._replace(bank_shards=shards),
                    registry=spec.registry._replace(
                        initial_classes=initial))
                reason = (f"fullest shard at {hot:.2f} of "
                          f"{view.rows_per_shard} rows, fused rows at "
                          f"{vmem:.2f} of VMEM budget -> bank_shards "
                          f"{spec.mesh.bank_shards} -> {shards}")
                return "escalate_shards", reason, target

    # 2. backend swap: the ACAM stage dominates the energy ledger
    total_j = view.backend_j + view.frontend_j
    if (spec.engine.backend == "kernel" and total_j > policy.min_energy_j
            and total_j > 0.0
            and view.backend_j / total_j >= policy.backend_energy_frac):
        engine = spec.engine._replace(backend="device",
                                      device_noise="per_shard")
        reason = (f"E_backend is {view.backend_j / total_j:.2f} of fleet "
                  "energy -> serve the matching stage on the RRAM device "
                  "backend")
        return "swap_backend", reason, spec._replace(engine=engine)

    # 3. slot widening: sustained saturation with a standing queue
    if (view.slots and view.rolling_fill >= policy.widen_fill_frac
            * view.slots
            and view.queue_depth >= policy.widen_queue_factor * view.slots):
        slots = min(view.slots * 2, policy.max_slots)
        if slots > view.slots:
            reason = (f"rolling fill {view.rolling_fill:.1f} saturates "
                      f"{view.slots} slots with queue_depth="
                      f"{view.queue_depth} -> slots {slots}")
            return "widen_slots", reason, spec._replace(
                scheduler=spec.scheduler._replace(slots=slots))

    return "hold", "no threshold crossed", spec


def decide(view: RegistryView,
           policy: PolicySpec = PolicySpec()) -> ServiceSpec:
    """The controller: frozen registry view in, next `ServiceSpec` out.
    Pure and deterministic (property-tested); returns the CURRENT spec
    when nothing should change."""
    return explain(view, policy)[2]


def should_compact(view: RegistryView,
                   policy: PolicySpec = PolicySpec()) -> bool:
    """The reclaim signal: occupancy fell below the threshold and the
    bank is above its minimal aligned capacity, so `registry.compact()`
    would actually return rows. Pure, like `decide`."""
    if not view.capacity_classes:
        return False
    used = sum(view.shard_rows_used)
    spec = view.spec
    align = spec.mesh.bank_shards * spec.registry.class_bucket
    minimal = max(align, -(-used // align) * align)
    return (used / view.capacity_classes < policy.compact_below
            and view.capacity_classes > minimal)
