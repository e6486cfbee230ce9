"""The hybrid service's control plane: build from one spec, then live
transitions, tenant manifests, compaction and snapshots.

`HybridService.from_spec(spec, device=None)` validates the spec and builds
registry -> scheduler -> cascade in order on ``device`` (the card unless the
caller asks for the CPU).

`service.reconfigure(new_spec)` diffs the spec in force against the new one
and runs the minimal live transition over a drained scheduler (the drained
requests are served under the OLD config and come back in the report):

    engine change     backend / method / fusion / noise swap: the next tick
                      dispatches under the new `EngineConfig`; taus are
                      re-resolved into the new backend's native units.
    scheduler change  a new tick size: the scheduler is rebuilt over the
                      same registry (the queue is empty after the drain).
    cascade change    taus, energy attribution and the admission bound are
                      re-derived for every registered tenant in place (a
                      `SemanticCacheService` swaps its cascade backend,
                      cnn <-> lm, this way: queued work drains under the
                      old one).

A different feature dim, ``k_max`` or bucket size would change the banks'
shapes: it raises `ReconfigureError` before anything changes. A change of
``mesh.bank_shards`` raises `NotImplementedError` (`ServiceSpec.validate`):
sharding the super-bank over several cards, and with it the live and
rolling reshard, mesh installs and device-loss failover, comes with the
multi-GPU slice of the port. A mesh change that keeps one shard has nothing
to install on one card.

`apply_manifest` diffs a `repro_torch.fleet.FleetManifest` against the one
in force (register / evict / update / retune over the hot paths);
`compact_registry` re-packs the super-bank after evictions; `snapshot` /
`restore` persist and rebuild the whole service through the atomic-rename
checkpointer (`repro_torch.serve.snapshot`), in the JAX package's format.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.device import resolve
from repro_torch.serve.acam_service import ACAMService, ClassifyResponse
from repro_torch.serve.spec import ServiceSpec


class ReconfigureError(ValueError):
    """The requested spec transition cannot be executed live."""


#: registry fields that shape the banks themselves: never live-mutable
_FROZEN_REGISTRY_FIELDS = ("num_features", "k_max", "class_bucket")


@dataclasses.dataclass
class ReconfigureReport:
    """What a live transition did (and what it cost)."""

    spec: ServiceSpec  # the spec now in force
    actions: tuple[str, ...]  # human-readable transition log
    drained: list[ClassifyResponse]  # requests served during the quiesce
    downtime_s: float  # drain start -> resume wall time
    tenants_moved: int = 0  # reshard: tenants whose class offset changed


@dataclasses.dataclass
class ManifestReport:
    """What `apply_manifest` did: tenant ids per transition kind (no drain:
    every transition rides the hot register/update/evict paths)."""

    manifest: "object"  # the FleetManifest now in force
    added: tuple[str, ...]
    evicted: tuple[str, ...]
    updated: tuple[str, ...]
    retuned: tuple[str, ...]
    duration_s: float

    @property
    def empty(self) -> bool:
        return not (self.added or self.evicted or self.updated
                    or self.retuned)


class HybridService(ACAMService):
    """`ACAMService` behind the declarative front door, with live
    transitions after."""

    @classmethod
    def from_spec(cls, spec: ServiceSpec, *, device=None) -> "HybridService":
        """Validate the spec, then build registry -> scheduler -> cascade."""
        spec.validate()
        svc = cls.__new__(cls)
        svc._build(spec, resolve(device))
        return svc

    def reconfigure(self, new_spec: ServiceSpec) -> ReconfigureReport:
        """Diff specs and run the minimal live transition (module
        docstring). Pending requests are drained, served under the OLD
        config, before anything switches; their responses come back in
        the report."""
        new_spec.validate()
        old = self.spec
        for field in _FROZEN_REGISTRY_FIELDS:
            if getattr(new_spec.registry, field) != \
                    getattr(old.registry, field):
                raise ReconfigureError(
                    f"registry.{field} cannot change live "
                    f"({getattr(old.registry, field)} -> "
                    f"{getattr(new_spec.registry, field)}): the registered "
                    "banks would change shape; build a fresh service")
        if new_spec == old:
            return ReconfigureReport(spec=old, actions=(), drained=[],
                                     downtime_s=0.0)

        t0 = time.perf_counter()
        drained = self.drain()
        actions: list[str] = []
        if new_spec.engine != old.engine:
            self.scheduler.set_engine(new_spec.engine)
            actions.append(f"engine {old.engine.backend}/{old.engine.method}"
                           f" -> {new_spec.engine.backend}/"
                           f"{new_spec.engine.method}")
        if new_spec.scheduler != old.scheduler:
            from repro_torch.serve.scheduler import MicroBatchScheduler

            stats = self.scheduler.stats  # the cumulative view stays whole
            self.scheduler = MicroBatchScheduler(
                self.registry, slots=new_spec.scheduler.slots,
                engine=new_spec.engine, monitor=self.scheduler.monitor,
                recorder=self.obs)
            self.scheduler.tau_fn = self._margin_tau_of
            stats.slots = new_spec.scheduler.slots
            self.scheduler.stats = stats
            self.obs.slots_gauge.set(new_spec.scheduler.slots)
            actions.append(f"scheduler slots {old.scheduler.slots} -> "
                           f"{new_spec.scheduler.slots}")
        if new_spec.cascade != old.cascade:
            actions.append("cascade re-derived (tau/energy/admission)")
        # always re-derive the cascade view: tau units depend on the engine
        # backend and method as much as on the cascade block itself
        self._apply_cascade(new_spec)
        self.spec = new_spec
        downtime_s = time.perf_counter() - t0
        self.obs.emit("reconfigure", actions=list(actions),
                      drained=len(drained),
                      duration_ms=round(downtime_s * 1e3, 3))
        return ReconfigureReport(spec=new_spec, actions=tuple(actions),
                                 drained=drained, downtime_s=downtime_s)

    # ------------------------------------------- fleet (repro_torch.fleet)

    def apply_manifest(self, manifest) -> ManifestReport:
        """Diff a `FleetManifest` against the one in force and run the
        minimal tenant transitions:

            only in new        register (bank from seed/checkpoint + head)
            only in old        evict
            bank source moved  hot update in place
            epoch bumped       evict + re-register (a fresh placement)
            tau-only change    retune the threshold (registry untouched)

        Per-tenant taus are converted from the manifest's declared units
        into the spec's `cascade.tau_units` (`fleet.manifest.tau_in_units`)
        before installation."""
        from repro_torch.fleet import manifest as manifest_lib

        new = manifest.validate().normalized()
        old = getattr(self, "_manifest", None) or \
            manifest_lib.FleetManifest()
        diff = manifest_lib.diff_manifests(old, new)
        t0 = time.perf_counter()
        n = self.registry.num_features
        units = self.spec.cascade.tau_units
        by_id = new.by_id()

        def _tau(t):
            return manifest_lib.tau_in_units(t.tau, t.tau_units, units, n)

        for tid in diff.evict:
            if tid in self.registry:
                self.evict_tenant(tid)
        for tid in diff.add:
            t = by_id[tid]
            bank, head = manifest_lib.materialize(t, n)
            if tid in self.registry:  # adopt an imperatively registered one
                self.update_tenant(tid, bank, head=head, margin_tau=_tau(t))
            else:
                self.register_tenant(tid, bank, head=head,
                                     margin_tau=_tau(t))
        for tid in diff.update:
            t = by_id[tid]
            bank, head = manifest_lib.materialize(t, n)
            self.update_tenant(tid, bank, head=head, margin_tau=_tau(t))
        for tid in diff.retune:
            self.retune_tenant(tid, margin_tau=_tau(by_id[tid]))
        self._manifest = new
        duration_s = time.perf_counter() - t0
        if not diff.empty:
            self.obs.emit("manifest_apply", added=list(diff.add),
                          evicted=list(diff.evict),
                          updated=list(diff.update),
                          retuned=list(diff.retune),
                          duration_ms=round(duration_s * 1e3, 3))
        return ManifestReport(manifest=new, added=diff.add,
                              evicted=diff.evict, updated=diff.update,
                              retuned=diff.retune, duration_s=duration_s)

    def compact_registry(self) -> int:
        """Re-pack the super-bank into its smallest capacity after
        evictions (`TemplateBankRegistry.compact`; the fleet policy's
        `should_compact` triggers it). Safe live: queued requests resolve
        placements at tick time. Returns the class rows freed."""
        return self.registry.compact()

    # ------------------------------------------------------- durability

    def snapshot(self, ckpt, step: int | None = None, *,
                 blocking: bool = True) -> int:
        """Persist the full service state (registry, placements, taus, head
        tables, spec) through the atomic-rename checkpointer. Returns the
        step written (`repro_torch.serve.snapshot`)."""
        from repro_torch.serve import snapshot as snapshot_lib

        step = snapshot_lib.save_snapshot(self, ckpt, step,
                                          blocking=blocking)
        self.obs.emit("snapshot", step=step, path=str(ckpt.dir))
        return step

    @classmethod
    def restore(cls, ckpt, step: int | None = None, *, device=None):
        """Rebuild a ready-to-serve service on ``device`` from its latest
        (or a given) snapshot, written by either package: the same preds,
        margins and escalations, zero tenant re-registrations. Returns
        ``(service, RestoreReport)``."""
        from repro_torch.serve import snapshot as snapshot_lib

        svc, report = snapshot_lib.restore_service(ckpt, step, cls=cls,
                                                   device=device)
        svc.obs.emit("restore", step=report.step,
                     resharded=report.resharded,
                     duration_ms=round(report.restore_s * 1e3, 3))
        return svc, report
