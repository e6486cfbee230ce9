"""Tenant manifests: a whole deployment's tenant set as ONE value.

A twin of the JAX package's `repro/fleet/manifest.py`, whose JSON it
reads and writes. `FleetManifest` is a hashable, JSON-round-trippable
NamedTuple tree,

    manifest = FleetManifest(tenants=(
        TenantSpec("t0", seed=17, num_classes=40, tau=6.0,
                   tau_units="count"),
        TenantSpec("t1", checkpoint="banks/t1.npz"),
    ))
    svc.apply_manifest(manifest)      # diffs vs the manifest in force

`HybridService.apply_manifest` diffs manifests exactly like `reconfigure`
diffs specs: tenants only in the new manifest are registered, tenants
only in the old are evicted, a changed bank source (seed / checkpoint
path / class count / k / head) hot-updates in place, and a tau-only
change retunes the threshold without touching the registry at all. All
of it rides the hot register/update/evict paths, so bucketed shapes stay
untouched and nothing retraces in the steady state.

Per-tenant banks come from one of two sources:

  * ``seed`` — `make_synthetic_tenant(seed, ...)`, the deterministic
    fixture every launcher/bench/test already shares;
  * ``checkpoint`` — an ``.npz`` written by `save_bank` (templates,
    lower, upper, valid, thresholds, optional head), the real-deployment
    path: recalibrate offline, point the manifest at the new file, apply.

``epoch`` is the manifest's "turn it off and on again" knob: bumping it
forces evict + re-register even when every other field is unchanged
(fresh placement, fresh `TenantEntry.generation`).

Tau overrides carry their OWN units (`tau_units`), independent of the
spec's `cascade.tau_units`: a manifest written in match counts serves
unchanged on a service whose spec speaks fractions — `tau_in_units`
converts at apply time via the same 1/N rule as `ServiceSpec.tau_scale`.
"""
from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.templates import TemplateBank
from repro_torch.serve.spec import TAU_UNITS


class ManifestError(ValueError):
    """Raised for malformed manifests / unloadable bank sources."""


class TenantSpec(NamedTuple):
    """One tenant's declared state: bank source + head + tau override."""

    tenant_id: str
    seed: int | None = None  # synthetic bank (make_synthetic_tenant)
    checkpoint: str | None = None  # .npz bank checkpoint (save_bank)
    num_classes: int = 10  # synthetic source only
    k: int = 1  # synthetic source only
    head: bool = True  # register the escalation head?
    tau: float | None = None  # per-tenant threshold (None: cascade default)
    tau_units: str = "count"  # units TAU is written in ("count"|"fraction")
    epoch: int = 0  # bump to force evict + re-register

    def validate(self) -> "TenantSpec":
        if not self.tenant_id:
            raise ManifestError("tenant_id must be non-empty")
        if (self.seed is None) == (self.checkpoint is None):
            raise ManifestError(
                f"tenant {self.tenant_id!r} needs exactly one bank source "
                f"(seed={self.seed}, checkpoint={self.checkpoint})")
        if self.num_classes < 1 or self.k < 1:
            raise ManifestError(
                f"tenant {self.tenant_id!r}: num_classes and k must be "
                f">= 1, got ({self.num_classes}, {self.k})")
        if self.tau_units not in TAU_UNITS:
            raise ManifestError(
                f"tenant {self.tenant_id!r}: unknown tau_units "
                f"{self.tau_units!r}; use {TAU_UNITS}")
        if self.tau is not None and self.tau <= 0:
            raise ManifestError(
                f"tenant {self.tenant_id!r}: tau must be > 0 (or None), "
                f"got {self.tau}")
        return self

    @property
    def bank_source(self) -> tuple:
        """The fields whose change means "reload the bank" (vs a tau-only
        retune): source identity + shape knobs + head presence + epoch."""
        return (self.seed, self.checkpoint, self.num_classes, self.k,
                self.head)


class FleetManifest(NamedTuple):
    """The deployment's declared tenant set (order-insensitive identity:
    two manifests with the same tenants in a different order are equal)."""

    tenants: tuple = ()  # tuple[TenantSpec, ...]

    def validate(self) -> "FleetManifest":
        seen = set()
        for t in self.tenants:
            t.validate()
            if t.tenant_id in seen:
                raise ManifestError(
                    f"duplicate tenant_id {t.tenant_id!r} in manifest")
            seen.add(t.tenant_id)
        hash(self.normalized())  # manifests key caches like specs do
        return self

    def normalized(self) -> "FleetManifest":
        """Canonical tenant order (by id) — the identity `apply_manifest`
        stores and diffs against."""
        return FleetManifest(tenants=tuple(
            sorted(self.tenants, key=lambda t: t.tenant_id)))

    def by_id(self) -> dict:
        return {t.tenant_id: t for t in self.tenants}

    # -- JSON ---------------------------------------------------------------

    def to_dict(self) -> dict:
        return {"tenants": [t._asdict() for t in self.normalized().tenants]}

    @classmethod
    def from_dict(cls, d: dict) -> "FleetManifest":
        return cls(tenants=tuple(TenantSpec(**t)
                                 for t in d.get("tenants", ())))

    def to_json(self, *, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "FleetManifest":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "FleetManifest":
        with open(path) as f:
            return cls.from_json(f.read())


class ManifestDiff(NamedTuple):
    """What `apply_manifest` will do, as sorted tenant-id tuples. A tenant
    whose ``epoch`` changed appears in BOTH `evict` and `add` (forced
    re-registration); `update` reloads the bank in place; `retune` only
    re-resolves the threshold."""

    add: tuple = ()
    evict: tuple = ()
    update: tuple = ()
    retune: tuple = ()

    @property
    def empty(self) -> bool:
        return not (self.add or self.evict or self.update or self.retune)


def diff_manifests(old: FleetManifest, new: FleetManifest) -> ManifestDiff:
    """Pure manifest diff (the tenant-set analogue of the spec diff in
    `HybridService.reconfigure`): minimal transitions, deterministic
    order."""
    o, n = old.by_id(), new.by_id()
    add = [t for t in n if t not in o]
    evict = [t for t in o if t not in n]
    update, retune = [], []
    for tid in sorted(set(o) & set(n)):
        ot, nt = o[tid], n[tid]
        if ot == nt:
            continue
        if ot.epoch != nt.epoch:
            evict.append(tid)  # forced re-registration: evict + re-add
            add.append(tid)
        elif ot.bank_source != nt.bank_source:
            update.append(tid)
        else:  # only tau / tau_units moved
            retune.append(tid)
    return ManifestDiff(add=tuple(sorted(add)), evict=tuple(sorted(evict)),
                        update=tuple(sorted(update)),
                        retune=tuple(sorted(retune)))


def tau_in_units(tau: float | None, given: str, target: str,
                 num_features: int) -> float | None:
    """Convert a tenant tau between "count" (0..N) and "fraction" (0..1)
    units — the same 1/N rule as `ServiceSpec.tau_scale`, applied at
    manifest apply time so a per-tenant override written in either unit
    lands in the spec's `cascade.tau_units` before `_resolve_tau` sees
    it."""
    if tau is None or given == target:
        return tau
    n = float(num_features)
    return tau / n if target == "fraction" else tau * n


# ---------------------------------------------------------------------------
# Bank materialisation (seed or checkpoint -> TemplateBank + head)
# ---------------------------------------------------------------------------

_BANK_FIELDS = ("templates", "lower", "upper", "valid", "thresholds")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_bank(path: str, bank: TemplateBank,
              head: tuple[np.ndarray, np.ndarray] | None = None) -> None:
    """Write a tenant bank (+ optional (W, b) head) as the ``.npz``
    checkpoint a manifest's ``checkpoint`` field points at (the JAX
    package's file: either package reads what the other wrote)."""
    arrays = {f: _host(getattr(bank, f)) for f in _BANK_FIELDS}
    if head is not None:
        arrays["head_w"] = np.asarray(head[0], np.float32)
        arrays["head_b"] = np.asarray(head[1], np.float32)
    np.savez(path, **arrays)


def load_bank(path: str):
    """Read a `save_bank` checkpoint back as ``(bank, head | None)``."""
    with np.load(path) as z:
        missing = [f for f in _BANK_FIELDS if f not in z]
        if missing:
            raise ManifestError(
                f"bank checkpoint {path!r} missing arrays {missing}")
        bank = TemplateBank(
            templates=z["templates"].astype(np.float32),
            lower=z["lower"].astype(np.float32),
            upper=z["upper"].astype(np.float32),
            valid=z["valid"].astype(bool),
            thresholds=z["thresholds"].astype(np.float32))
        head = (z["head_w"], z["head_b"]) if "head_w" in z else None
    return bank, head


def materialize(tenant: TenantSpec, num_features: int):
    """Resolve a tenant's declared bank source into ``(bank, head)``:
    synthetic seed (a bank of CPU tensors) or checkpoint file (numpy
    arrays). ``head`` is None when the manifest disables the escalation
    head."""
    if tenant.checkpoint is not None:
        bank, head = load_bank(tenant.checkpoint)
    else:
        from repro_torch.serve.acam_service import make_synthetic_tenant

        bank, head, _ = make_synthetic_tenant(
            tenant.seed, num_classes=tenant.num_classes, k=tenant.k,
            num_features=num_features)
    if bank.templates.shape[-1] != num_features:
        raise ManifestError(
            f"tenant {tenant.tenant_id!r}: bank has "
            f"{bank.templates.shape[-1]} features, service serves "
            f"{num_features}")
    return bank, (head if tenant.head else None)
