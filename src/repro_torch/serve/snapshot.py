"""Durable service state: snapshot/restore for the hybrid serving tier.

A `HybridService` holds state a restart would erase: the registry's
super-bank and tenant placements, per-tenant thresholds and taus, the
stacked CNN escalation heads, and the `ServiceSpec` in force. This module
folds all of it into one tree and writes it through the atomic-rename
`repro_torch.checkpoint.Checkpointer`, so a killed service restarts from
its last durable snapshot and serves the same predictions, margins and
escalation decisions bit for bit: the restored super-bank is the same
bytes, the taus resolve to the same values, the heads are the same tables.

The layout is the JAX package's (`repro/serve/snapshot.py`): the registry
arrays and head tables as ``.npy`` leaves, plus a ``meta`` leaf holding the
JSON metadata (the spec's ``to_dict``, tenant placements, runtimes,
counters) as a uint8 array. The two packages' specs serialise alike, so a
snapshot written by either restores in the other.

Restore boots through the spec front door with ``mesh.install`` off (as
the JAX package does), adopts the snapshot wholesale
(`TemplateBankRegistry.load_state`: no `register()` call), and then
reconfigures to the snapshot's own spec.

    ckpt = Checkpointer("/var/lib/acam/ckpt")
    svc.snapshot(ckpt)                      # periodic, async-capable
    ...process dies...
    svc, report = HybridService.restore(ckpt)
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import energy as energy_lib
from repro_torch.serve.spec import ServiceSpec

_FORMAT = 1


class SnapshotError(RuntimeError):
    """No usable snapshot, or the snapshot does not fit the request."""


@dataclasses.dataclass(frozen=True)
class RestoreReport:
    """What a restore did, and what it cost (the recovery time)."""

    step: int  # checkpoint step restored from
    spec: ServiceSpec  # spec now in force
    tenants: int  # placements adopted, zero re-registrations
    restore_s: float  # load -> service ready wall time
    resharded: bool  # True: restored onto a different shard count
    actions: tuple[str, ...]  # reconfigure transition log


def service_state(svc) -> dict:
    """The service's full durable state as one dict tree of host numpy
    copies (safe to hand to the async checkpoint writer)."""
    arrays, reg_meta = svc.registry.snapshot_state()
    meta = {
        "format": _FORMAT,
        "spec": svc.spec.to_dict(),
        "registry": reg_meta,
        "tenants": {tid: {"has_head": rt.has_head, "raw_tau": rt.raw_tau}
                    for tid, rt in svc._tenants.items()},
        "next_id": svc._next_id,
        "has_heads": svc._head_w is not None,
    }
    # service-subclass hook: JSON-serialisable state that must ride the
    # same atomic snapshot as the registry arrays it indexes into
    extra = getattr(svc, "_extra_snapshot_state", None)
    if extra is not None:
        meta["extra"] = extra()
    tree = {"registry": arrays,
            "meta": np.frombuffer(json.dumps(meta).encode("utf-8"),
                                  dtype=np.uint8).copy()}
    if svc._head_w is not None:
        tree["head_w"] = svc._head_w.copy()
        tree["head_b"] = svc._head_b.copy()
    return tree


def save_snapshot(svc, ckpt: Checkpointer, step: int | None = None, *,
                  blocking: bool = True) -> int:
    """Persist the service through the checkpointer's atomic-rename path.
    ``step=None`` continues the directory's step sequence (a restarted
    service keeps counting from where the last one stopped). Returns the
    step written (or queued, when ``blocking=False``)."""
    if step is None:
        last = ckpt.latest_step()
        step = (max(last if last is not None else -1,
                    getattr(svc, "_last_snapshot_step", -1)) + 1)
    svc._last_snapshot_step = step
    ckpt.save(step, service_state(svc), blocking=blocking)
    return step


def load_state(ckpt: Checkpointer, step: int | None = None
               ) -> tuple[int, dict, dict]:
    """Read a snapshot back: ``(step, meta, tree)``. ``step=None`` picks
    the latest complete step."""
    if step is None:
        step = ckpt.latest_step()
        if step is None:
            raise SnapshotError(f"no complete snapshot under {ckpt.dir}")
    tree = ckpt.restore_dict(step)
    meta = json.loads(bytes(np.asarray(tree["meta"], np.uint8)).decode())
    if meta.get("format") != _FORMAT:
        raise SnapshotError(f"snapshot format {meta.get('format')!r} != "
                            f"supported {_FORMAT}")
    return step, meta, tree


def restore_service(ckpt: Checkpointer, step: int | None = None, *,
                    cls=None, device=None):
    """Rebuild a ready-to-serve `HybridService` on ``device`` (the card
    unless the caller asks for the CPU) from its latest (or a given)
    snapshot. Returns ``(service, RestoreReport)``."""
    from repro_torch.serve.acam_service import _TenantRuntime
    from repro_torch.serve.control import HybridService

    t0 = time.perf_counter()
    step, meta, tree = load_state(ckpt, step)
    spec = ServiceSpec.from_dict(meta["spec"])

    cls = cls or HybridService
    svc = cls.from_spec(spec._replace(mesh=spec.mesh._replace(install=False)),
                        device=device)
    svc.registry.load_state(tree["registry"], meta["registry"])
    if meta["has_heads"]:
        svc._head_w = np.array(tree["head_w"], np.float32)
        svc._head_b = np.array(tree["head_b"], np.float32)
        svc._head_gen += 1
        svc._head_cache = None
    svc._next_id = int(meta["next_id"])
    svc._last_snapshot_step = step
    for tid, info in meta["tenants"].items():
        entry = svc.registry.get(tid)  # placement adopted, not re-registered
        svc._tenants[tid] = _TenantRuntime(
            has_head=info["has_head"], raw_tau=info["raw_tau"],
            margin_tau=svc._resolve_tau(info["raw_tau"])
            if info["has_head"] else None,
            backend_j=energy_lib.backend_energy(
                entry.valid_rows, svc.registry.num_features))
    # subclass hook: adopt extra state after the registry and tenants exist
    adopt = getattr(svc, "_adopt_snapshot_state", None)
    if adopt is not None:
        adopt(meta.get("extra") or {})

    actions: tuple[str, ...] = ()
    if spec != svc.spec:
        actions = svc.reconfigure(spec).actions
    return svc, RestoreReport(
        step=step, spec=svc.spec, tenants=len(meta["tenants"]),
        restore_s=time.perf_counter() - t0,
        resharded=spec.mesh.bank_shards != meta["registry"]["bank_shards"],
        actions=actions)
