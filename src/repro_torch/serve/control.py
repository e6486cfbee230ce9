"""The hybrid service's control plane: build from one spec, then live
transitions, tenant manifests, compaction, snapshots and device failover.

`HybridService.from_spec(spec, device=None)` validates the spec, installs
its mesh when the spec owns one (``mesh.install``: a (data =
devices/bank_shards, model = bank_shards) grid over
`repro_torch.distributed.context.devices(device)`), then builds registry
-> scheduler -> cascade in order on ``device`` (the card unless the caller
asks for the CPU), so registry placement and the engine's `PartitionPlan`
never disagree about the shard count.

`service.reconfigure(new_spec)` diffs the spec in force against the new one
and runs the minimal live transition over a drained scheduler (the drained
requests are served under the OLD config and come back in the report):

    bank_shards change  LIVE RESHARD: drain -> `registry.reshard` re-packs
                      the bucket runs to the new shard boundaries (zero
                      re-registrations) -> install the new mesh -> the next
                      tick runs under the new plan. Predictions, margins
                      and escalations are bit-identical across it (the
                      engine's exact cross-shard merge), except for the
                      device backend under ``device_noise="per_shard"`` at
                      ``sigma_program > 0``, where the shard count IS the
                      physical tiling and resharding re-draws the noise.
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
shapes, and a shard count that does not divide the available devices
cannot form a mesh: both raise `ReconfigureError` before anything changes.

`rolling_reshard` is the double-buffered reshard (`repro_torch.fleet.
reshard`): the re-packed bank is built beside the live one and flipped
between ticks, with no drain. `handle_device_loss` degrades the live
service onto the surviving devices (the largest shard count they can form,
an ordinary reconfigure); `restore_devices` heals back to the full device
list. `apply_manifest` diffs a `repro_torch.fleet.FleetManifest` against
the one in force (register / evict / update / retune over the hot paths);
`compact_registry` re-packs the super-bank after evictions; `snapshot` /
`restore` persist and rebuild the whole service through the atomic-rename
checkpointer (`repro_torch.serve.snapshot`), in the JAX package's format,
optionally onto another mesh.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.device import resolve
from repro_torch.serve.acam_service import ACAMService, ClassifyResponse
from repro_torch.serve.spec import MeshSpec, ServiceSpec


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


def install_mesh(mesh: MeshSpec, devices=None, *, device=None):
    """Build and install the (data = devices/bank_shards, model =
    bank_shards) serving mesh a `MeshSpec` describes; returns it.
    ``devices`` restricts the mesh to a survivor list (the degraded path
    `handle_device_loss` takes); default `context.devices(device)`.
    Raises `ValueError` when ``bank_shards`` does not divide the devices:
    two shards never share a device unless a forced mesh asked for it."""
    from repro_torch.distributed import context
    from repro_torch.launch.mesh import make_serving_mesh

    built = make_serving_mesh(bank_shards=mesh.bank_shards,
                              axis_names=(mesh.data_axis, mesh.model_axis),
                              devices=devices, device=device)
    context.set_mesh_axes(mesh.data_axis, mesh.model_axis, built)
    return built


def _with_shards(spec: ServiceSpec, shards: int) -> ServiceSpec:
    """``spec`` at ``shards`` bank shards, its registry's initial capacity
    rounded up to whole buckets a shard (a survivor count such as 3 needs
    48-row multiples; the JAX package's spec validation refuses there)."""
    align = shards * spec.registry.class_bucket
    initial = -(-spec.registry.initial_classes // align) * align
    return spec._replace(
        mesh=spec.mesh._replace(bank_shards=shards),
        registry=spec.registry._replace(initial_classes=initial))


class HybridService(ACAMService):
    """`ACAMService` behind the declarative front door, with live
    transitions after."""

    @classmethod
    def from_spec(cls, spec: ServiceSpec, *, device=None) -> "HybridService":
        """Validate the spec, install its mesh when it owns one, then build
        registry -> scheduler -> cascade on ``device``."""
        spec.validate()
        dev = resolve(device)
        svc = cls.__new__(cls)
        if spec.mesh.install:
            install_mesh(spec.mesh, device=dev)
        svc._build(spec, dev)
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
        if new_spec.mesh.install:
            # fail BEFORE any change: a mesh the devices cannot form must
            # not strand a resharded registry behind the old mesh (after a
            # device loss, "available" means the survivors)
            ndev = len(self._avail_devices())
            if ndev % new_spec.mesh.bank_shards:
                raise ReconfigureError(
                    f"mesh.bank_shards={new_spec.mesh.bank_shards} does not "
                    f"divide the {ndev} available devices; nothing was "
                    "changed")
        if new_spec == old:
            return ReconfigureReport(spec=old, actions=(), drained=[],
                                     downtime_s=0.0)

        t0 = time.perf_counter()
        drained = self.drain()
        actions: list[str] = []
        moved = 0
        reshard = new_spec.mesh.bank_shards != old.mesh.bank_shards
        if reshard:
            moved = self.registry.reshard(new_spec.mesh.bank_shards)
            actions.append(
                f"resharded super-bank {old.mesh.bank_shards} -> "
                f"{new_spec.mesh.bank_shards} ({moved} tenant runs "
                f"re-packed, 0 re-registrations)")
            self.obs.emit("reshard",
                          bank_shards_from=old.mesh.bank_shards,
                          bank_shards_to=new_spec.mesh.bank_shards)
        if (new_spec.mesh != old.mesh or reshard) and new_spec.mesh.install:
            install_mesh(new_spec.mesh, devices=self._devices,
                         device=self.device)
            actions.append(
                f"installed ({new_spec.mesh.data_axis}, "
                f"{new_spec.mesh.model_axis}={new_spec.mesh.bank_shards})"
                " mesh (generation bump)")
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
                                 drained=drained, downtime_s=downtime_s,
                                 tenants_moved=moved)

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

    def rolling_reshard(self, new_spec: ServiceSpec, *,
                        prepared=None) -> ReconfigureReport:
        """The double-buffered reshard (`repro_torch.fleet.reshard`): build
        the re-packed super-bank beside the live one, then flip between
        ticks with NO drain; the downtime is the flip and the mesh install.
        The same preds, margins and escalations as the drained
        `reconfigure`. ``prepared`` (from `fleet.reshard.prepare`) flips a
        buffer built earlier; without it this prepares and flips back to
        back."""
        from repro_torch.fleet import reshard as reshard_lib

        if prepared is None:
            prepared = reshard_lib.prepare(self, new_spec)
        return reshard_lib.flip(self, prepared)

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
    def restore(cls, ckpt, step: int | None = None, *,
                mesh: MeshSpec | None = None, device=None):
        """Rebuild a ready-to-serve service on ``device`` from its latest
        (or a given) snapshot, written by either package: the same preds,
        margins and escalations, zero tenant re-registrations. ``mesh``
        restores onto a DIFFERENT mesh (shrink or grow across a restart).
        Returns ``(service, RestoreReport)``."""
        from repro_torch.serve import snapshot as snapshot_lib

        svc, report = snapshot_lib.restore_service(ckpt, step, mesh=mesh,
                                                   cls=cls, device=device)
        svc.obs.emit("restore", step=report.step,
                     resharded=report.resharded,
                     duration_ms=round(report.restore_s * 1e3, 3))
        return svc, report

    # --------------------------------------------------- elastic failover

    def _avail_devices(self) -> list:
        """The devices the control plane may build meshes over: all of
        `context.devices()` minus any reported lost."""
        from repro_torch.distributed import context

        if self._devices is not None:
            return list(self._devices)
        return context.devices(self.device)

    def handle_device_loss(self, lost) -> ReconfigureReport:
        """Degrade after a (simulated) device failure: drop the lost
        devices, pick the largest shard count the survivors can form
        (capped at the current one), and reshard the live service onto
        them.

        ``lost`` holds indices into the full `context.devices()` list.
        Losses accumulate across calls; `restore_devices` heals. The
        reshard is the ordinary `reconfigure` transition: zero tenant
        re-registrations, the same results after the shrink.
        """
        from repro_torch.distributed import context

        all_devs = context.devices(self.device)
        if not self._lost_devices:
            self._healthy_spec = self.spec
        for i in lost:
            if not 0 <= i < len(all_devs):
                raise ReconfigureError(
                    f"device index {i} out of range (fleet has "
                    f"{len(all_devs)} devices)")
            self._lost_devices.add(int(i))
        survivors = [d for i, d in enumerate(all_devs)
                     if i not in self._lost_devices]
        if not survivors:
            raise ReconfigureError("all devices lost; nothing to serve on")
        self._devices = survivors

        # device loss never widens the model axis
        shards = min(self.spec.mesh.bank_shards, len(survivors))
        while len(survivors) % shards:
            shards -= 1
        target = _with_shards(self.spec, shards)
        if target != self.spec:
            report = self.reconfigure(target)
        else:
            # same spec, fewer devices: the mesh itself must still shrink
            t0 = time.perf_counter()
            drained = self.drain()
            actions: tuple[str, ...] = ()
            if self.spec.mesh.install:
                install_mesh(self.spec.mesh, devices=survivors)
                actions = (f"reinstalled mesh on {len(survivors)} "
                           "surviving devices (generation bump)",)
            report = ReconfigureReport(
                spec=self.spec, actions=actions, drained=drained,
                downtime_s=time.perf_counter() - t0)
        self.obs.emit("device_loss", lost=sorted(self._lost_devices),
                      survivors=len(survivors))
        return dataclasses.replace(
            report, actions=report.actions + (
                f"device loss: {len(self._lost_devices)} down, "
                f"{len(survivors)} surviving, bank_shards={shards}",))

    def restore_devices(self) -> ReconfigureReport:
        """Heal: forget recorded losses and rebuild the spec's mesh over
        the full device list (the repair-complete transition). Where the
        losses left a shard count that does not divide the full list (4
        devices, 3 shards), the heal reshards back to the count in force
        before the first loss; the JAX package raises there."""
        from repro_torch.distributed import context

        self._lost_devices.clear()
        self._devices = None
        shards = self.spec.mesh.bank_shards
        if self.spec.mesh.install and \
                len(context.devices(self.device)) % shards:
            healthy = self._healthy_spec.mesh.bank_shards
            report = self.reconfigure(_with_shards(self.spec, healthy))
            self.obs.emit("device_heal",
                          restored=len(self._avail_devices()))
            return dataclasses.replace(report, actions=report.actions + (
                f"restored full fleet: bank_shards {shards} -> "
                f"{healthy}",))
        t0 = time.perf_counter()
        drained = self.drain()
        actions: tuple[str, ...] = ()
        if self.spec.mesh.install:
            install_mesh(self.spec.mesh, device=self.device)
            actions = ("restored full fleet: mesh reinstalled over all "
                       "devices",)
        self.obs.emit("device_heal", restored=len(self._avail_devices()))
        return ReconfigureReport(spec=self.spec, actions=actions,
                                 drained=drained,
                                 downtime_s=time.perf_counter() - t0)
