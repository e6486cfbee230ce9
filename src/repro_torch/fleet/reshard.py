"""Double-buffered rolling reshard: re-pack beside, flip between ticks.

The port of `repro/fleet/reshard.py`. The drained reshard (`reconfigure`)
quiesces the scheduler before `registry.reshard` re-packs in place. The
queue holds only tenant ids, though: placements are resolved at tick time
(`registry.lookup`) and every tick re-reads `device_bank()` /
`thresholds_table()` per generation, so nothing about a queued request
pins the OLD packing, and a pure shard-count change needs no drain:

    prepare(svc, new_spec)   copy every tenant's rows into a SHADOW bank
                             packed to the new shard boundaries
                             (`registry.prepare_reshard`) while the live
                             bank keeps serving: the O(rows) work, off the
                             serving path;
    flip(svc, prep)          between two ticks: swap the host arrays and
                             offsets (`adopt_prepared`, O(tenants)), bump
                             the generation, install the new mesh. The next
                             tick uploads the re-packed super-bank and runs
                             under the new `PartitionPlan`.

The downtime is the flip alone. Preds, margins and escalations equal the
drained path's: the engine's cross-shard merge is exact and the queue is
FIFO either way.

A prepared buffer is generation-stamped: any registry mutation between
prepare and flip makes it stale, `flip` raises `RegistryError`, and the
caller re-prepares (the autopilot does).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.serve.control import (_FROZEN_REGISTRY_FIELDS,
                                       ReconfigureError, ReconfigureReport,
                                       install_mesh)
from repro_torch.serve.registry import PreparedBank, RegistryError
from repro_torch.serve.spec import ServiceSpec


@dataclasses.dataclass
class PreparedReshard:
    """A shadow super-bank ready to flip to, and the spec it implements."""

    spec: ServiceSpec  # the target spec (only the mesh differs)
    prepared: PreparedBank  # registry.prepare_reshard output
    build_s: float  # shadow-build wall time (overlapped with serving)

    @property
    def stale(self) -> bool:
        return self._registry.generation != self.prepared.source_generation

    _registry: object = None  # the registry the buffer was built from


def prepare(service, new_spec: ServiceSpec) -> PreparedReshard:
    """Build the re-packed shadow bank for ``new_spec`` while ``service``
    keeps serving. Only a mesh (shard-count) change may be pending:
    engine, scheduler or cascade changes alter how queued requests are
    served and take the drained `reconfigure` path."""
    new_spec.validate()
    old = service.spec
    for field in _FROZEN_REGISTRY_FIELDS:
        if getattr(new_spec.registry, field) != getattr(old.registry, field):
            raise ReconfigureError(
                f"registry.{field} cannot change live; build a fresh "
                "service")
    if (new_spec.engine != old.engine
            or new_spec.scheduler != old.scheduler
            or new_spec.cascade != old.cascade):
        raise ReconfigureError(
            "rolling reshard only covers mesh/bank_shards changes "
            "(queued requests must serve identically across the flip); "
            "use reconfigure for engine/scheduler/cascade deltas")
    if new_spec.mesh.install:
        ndev = len(service._avail_devices())
        if ndev % new_spec.mesh.bank_shards:
            raise ReconfigureError(
                f"mesh.bank_shards={new_spec.mesh.bank_shards} does not "
                f"divide the {ndev} available devices")
    t0 = time.perf_counter()
    prepared = service.registry.prepare_reshard(new_spec.mesh.bank_shards)
    return PreparedReshard(spec=new_spec, prepared=prepared,
                           build_s=time.perf_counter() - t0,
                           _registry=service.registry)


def flip(service, prep: PreparedReshard) -> ReconfigureReport:
    """Adopt the shadow bank between ticks: swap arrays and offsets,
    install the new mesh, re-derive the cascade view. NO drain: the queue
    rides through and the next tick runs under the new `PartitionPlan`.
    Raises `RegistryError` when the buffer went stale."""
    old = service.spec
    t0 = time.perf_counter()
    moved = service.registry.adopt_prepared(prep.prepared)  # may raise
    actions = [
        f"flipped double-buffered super-bank {old.mesh.bank_shards} -> "
        f"{prep.spec.mesh.bank_shards} ({moved} tenant runs re-packed "
        "off-path, 0 re-registrations, 0 drained)"]
    service.obs.emit("reshard", bank_shards_from=old.mesh.bank_shards,
                     bank_shards_to=prep.spec.mesh.bank_shards)
    if prep.spec.mesh.install:
        install_mesh(prep.spec.mesh, devices=service._devices,
                     device=service.device)
        actions.append(
            f"installed ({prep.spec.mesh.data_axis}, "
            f"{prep.spec.mesh.model_axis}={prep.spec.mesh.bank_shards}) "
            "mesh (generation bump)")
    service._apply_cascade(prep.spec)
    service.spec = prep.spec
    downtime_s = time.perf_counter() - t0
    service.obs.emit("buffer_flip",
                     bank_shards_from=old.mesh.bank_shards,
                     bank_shards_to=prep.spec.mesh.bank_shards,
                     tenants_moved=moved,
                     flip_ms=round(downtime_s * 1e3, 4),
                     build_ms=round(prep.build_s * 1e3, 4))
    return ReconfigureReport(spec=prep.spec, actions=tuple(actions),
                             drained=[], downtime_s=downtime_s,
                             tenants_moved=moved)


__all__ = ["PreparedReshard", "prepare", "flip", "RegistryError"]
