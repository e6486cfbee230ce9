"""Multi-tenant ACAM template-bank registry (the serving super-bank).

One small `TemplateBank` per tenant is padded and stacked into ONE
device-resident super-bank (on ``device``: the card unless the caller asks
for the CPU), so a scheduler tick serves every tenant with a single kernel
call:

  * tenant classes occupy a contiguous row range ``[offset, offset + C)``
    of a shared ``(C_cap, K_max, N)`` bank; each request's Eq. 12 decision
    is restricted to its tenant's range by the kernel's class window;
  * per-tenant binarisation thresholds live in a ``(T_cap, N)`` table that
    the serve kernel gathers per slot;
  * class ranges are allocated in ``class_bucket`` units and capacities
    (``C_cap``, ``T_cap``) only ever grow by doubling, so hot register /
    update / evict leave the device shapes unchanged in the steady state.

Host numpy mirrors hold the authoritative state; the device tensors
(`device_bank`, `thresholds_table`) are rebuilt lazily on the registry's
device and cached per `generation`, so an unchanged registry never
re-uploads. Resharding, compaction and snapshots come with later slices of
the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.templates import TemplateBank
from repro_torch.device import resolve


class RegistryError(ValueError):
    """Raised for invalid register/update/evict operations."""


@dataclasses.dataclass(frozen=True)
class TenantEntry:
    """Immutable snapshot of a tenant's placement in the super-bank."""

    tenant_id: str
    slot: int  # row in the thresholds (and service head) tables
    offset: int  # first class row in the super-bank
    num_classes: int  # true class count
    c_bucket: int  # allocated (bucketed) class rows
    k: int  # true templates-per-class
    valid_rows: int  # programmed template rows (ACAM energy, Eq. 14)
    generation: int  # registry generation at (re)registration

    @property
    def window(self) -> tuple[int, int]:
        """The tenant's Eq. 12 class window [lo, hi) in the super-bank."""
        return self.offset, self.offset + self.num_classes


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TemplateBankRegistry:
    """Registry of per-tenant `TemplateBank`s stacked into one super-bank."""

    def __init__(self, num_features: int, *, k_max: int = 2,
                 class_bucket: int = 16, initial_classes: int = 128,
                 initial_tenants: int = 8, device=None):
        if initial_classes % class_bucket:
            raise ValueError("initial_classes must be a class_bucket multiple")
        self.num_features = num_features
        self.k_max = k_max
        self.class_bucket = class_bucket
        self.device = resolve(device)
        self._c_cap = initial_classes
        self._t_cap = initial_tenants
        n = num_features
        self._templates = np.zeros((self._c_cap, k_max, n), np.float32)
        self._lower = np.zeros((self._c_cap, k_max, n), np.float32)
        self._upper = np.zeros((self._c_cap, k_max, n), np.float32)
        self._valid = np.zeros((self._c_cap, k_max), bool)
        self._thr = np.zeros((self._t_cap, n), np.float32)
        self._bucket_used = np.zeros(self._c_cap // class_bucket, bool)
        self._slot_used = np.zeros(self._t_cap, bool)
        self._tenants: dict[str, TenantEntry] = {}
        self.generation = 0
        self._device_cache: tuple[int, TemplateBank] | None = None
        self._thr_cache: tuple[int, torch.Tensor] | None = None

    # -- introspection ------------------------------------------------------

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    def get(self, tenant_id: str) -> TenantEntry:
        try:
            return self._tenants[tenant_id]
        except KeyError:
            raise RegistryError(f"unknown tenant {tenant_id!r}") from None

    def lookup(self, tenant_id: str) -> TenantEntry | None:
        """Non-raising `get`: the scheduler re-resolves entries at tick time
        so queued requests see the tenant's *current* placement."""
        return self._tenants.get(tenant_id)

    @property
    def capacity_tenants(self) -> int:
        return self._t_cap

    def stats(self) -> dict:
        return {
            "tenants": len(self._tenants),
            "generation": self.generation,
            "capacity_classes": self._c_cap,
            "capacity_tenants": self._t_cap,
            "used_class_buckets": int(self._bucket_used.sum()),
            "programmed_rows": int(self._valid.sum()),
        }

    def rows_used(self) -> int:
        """Allocated class rows (bucket granularity)."""
        return int(self._bucket_used.sum()) * self.class_bucket

    # -- allocation ---------------------------------------------------------

    def _alloc_classes(self, n_buckets: int) -> int:
        """First-fit contiguous bucket run; grows capacity (doubling) when
        fragmented or full — the only event that changes device shapes."""
        while True:
            run = 0
            for i, used in enumerate(self._bucket_used):
                run = 0 if used else run + 1
                if run == n_buckets:
                    start = i - n_buckets + 1
                    self._bucket_used[start:i + 1] = True
                    return start * self.class_bucket
            self._grow_classes()

    def _grow_classes(self) -> None:
        old = self._c_cap
        self._c_cap *= 2
        for name in ("_templates", "_lower", "_upper", "_valid"):
            arr = getattr(self, name)
            grown = np.zeros((self._c_cap,) + arr.shape[1:], arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        used = np.zeros(self._c_cap // self.class_bucket, bool)
        used[:old // self.class_bucket] = self._bucket_used
        self._bucket_used = used

    def _alloc_slot(self) -> int:
        free = np.flatnonzero(~self._slot_used)
        if free.size == 0:
            old = self._t_cap
            self._t_cap *= 2
            thr = np.zeros((self._t_cap, self.num_features), np.float32)
            thr[:old] = self._thr
            self._thr = thr
            used = np.zeros(self._t_cap, bool)
            used[:old] = self._slot_used
            self._slot_used = used
            free = np.flatnonzero(~self._slot_used)
        slot = int(free[0])
        self._slot_used[slot] = True
        return slot

    # -- mutation -----------------------------------------------------------

    def _check_bank(self, bank: TemplateBank) -> tuple[int, int]:
        c, k, n = bank.templates.shape
        if n != self.num_features:
            raise RegistryError(
                f"bank has {n} features, registry serves {self.num_features}")
        if k > self.k_max:
            raise RegistryError(f"bank k={k} exceeds registry k_max={self.k_max}")
        return c, k

    def _write(self, offset: int, c_bucket: int, bank: TemplateBank) -> int:
        c, k = bank.templates.shape[0], bank.templates.shape[1]
        end = offset + c_bucket
        self._templates[offset:end] = 0.0
        self._lower[offset:end] = 0.0
        self._upper[offset:end] = 0.0
        self._valid[offset:end] = False
        self._templates[offset:offset + c, :k] = _host(bank.templates)
        self._lower[offset:offset + c, :k] = _host(bank.lower)
        self._upper[offset:offset + c, :k] = _host(bank.upper)
        valid = _host(bank.valid).astype(bool)
        self._valid[offset:offset + c, :k] = valid
        return int(valid.sum())

    def _bump(self) -> None:
        self.generation += 1
        self._device_cache = None
        self._thr_cache = None

    def register(self, tenant_id: str, bank: TemplateBank) -> TenantEntry:
        """Hot-register a tenant's bank: allocate a bucketed class range,
        write templates + thresholds."""
        if tenant_id in self._tenants:
            raise RegistryError(f"tenant {tenant_id!r} already registered; "
                                "use update()")
        c, k = self._check_bank(bank)
        n_buckets = -(-c // self.class_bucket)
        offset = self._alloc_classes(n_buckets)
        slot = self._alloc_slot()
        rows = self._write(offset, n_buckets * self.class_bucket, bank)
        self._thr[slot] = _host(bank.thresholds)
        self._bump()
        entry = TenantEntry(tenant_id, slot, offset, c,
                            n_buckets * self.class_bucket, k, rows,
                            self.generation)
        self._tenants[tenant_id] = entry
        return entry

    def update(self, tenant_id: str, bank: TemplateBank) -> TenantEntry:
        """Hot-update a tenant's bank in place, or relocate it (same slot)
        when the new bank outgrows its bucket run."""
        old = self.get(tenant_id)
        c, k = self._check_bank(bank)
        if c <= old.c_bucket:
            rows = self._write(old.offset, old.c_bucket, bank)
            self._thr[old.slot] = _host(bank.thresholds)
            self._bump()
            entry = dataclasses.replace(old, num_classes=c, k=k,
                                        valid_rows=rows,
                                        generation=self.generation)
        else:
            self._free_classes(old)
            n_buckets = -(-c // self.class_bucket)
            offset = self._alloc_classes(n_buckets)
            rows = self._write(offset, n_buckets * self.class_bucket, bank)
            self._thr[old.slot] = _host(bank.thresholds)
            self._bump()
            entry = TenantEntry(tenant_id, old.slot, offset, c,
                                n_buckets * self.class_bucket, k, rows,
                                self.generation)
        self._tenants[tenant_id] = entry
        return entry

    def _free_classes(self, entry: TenantEntry) -> None:
        end = entry.offset + entry.c_bucket
        self._valid[entry.offset:end] = False
        self._templates[entry.offset:end] = 0.0
        start = entry.offset // self.class_bucket
        self._bucket_used[start:start + entry.c_bucket // self.class_bucket] \
            = False

    def evict(self, tenant_id: str) -> None:
        """Drop a tenant: invalidate its rows, free its bucket range + slot."""
        entry = self.get(tenant_id)
        self._free_classes(entry)
        self._slot_used[entry.slot] = False
        del self._tenants[tenant_id]
        self._bump()

    # -- device views -------------------------------------------------------

    def device_bank(self) -> TemplateBank:
        """The (C_cap, K_max, N) super-bank on the registry's device, cached
        per generation. Its thresholds are zeros: per-tenant thresholds are
        applied per slot from `thresholds_table`."""
        if self._device_cache is None or \
                self._device_cache[0] != self.generation:
            dev = self.device
            # torch.tensor copies: later host writes never reach a served bank
            bank = TemplateBank(
                templates=torch.tensor(self._templates, device=dev),
                lower=torch.tensor(self._lower, device=dev),
                upper=torch.tensor(self._upper, device=dev),
                valid=torch.tensor(self._valid, device=dev),
                thresholds=torch.zeros((self.num_features,),
                                       dtype=torch.float32, device=dev))
            self._device_cache = (self.generation, bank)
        return self._device_cache[1]

    def thresholds_table(self) -> torch.Tensor:
        """(T_cap, N) per-tenant binarisation thresholds, cached."""
        if self._thr_cache is None or self._thr_cache[0] != self.generation:
            self._thr_cache = (self.generation,
                               torch.tensor(self._thr, device=self.device))
        return self._thr_cache[1]
