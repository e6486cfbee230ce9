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
re-uploads.

With ``bank_shards=S`` (the spec path passes `ServiceSpec.mesh.bank_shards`)
capacity stays divisible by S whole buckets and no tenant's bucket run
straddles a shard boundary (`_alloc_classes` skips to the next shard), so
a tenant's rows share a device under the engine's bank-sharded plan.
`reshard` re-packs the runs to new shard boundaries with zero
re-registrations; `prepare_reshard` + `adopt_prepared` is its
double-buffered form (`repro_torch.fleet.reshard`). `compact` re-packs
every tenant into the smallest capacity after evictions, and
`snapshot_state` / `load_state` carry the whole durable state
(`repro_torch.serve.snapshot`) in the JAX package's layout, so a snapshot
restores in either package.
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


@dataclasses.dataclass
class PreparedBank:
    """A shadow super-bank built beside the live one (`_build_shadow`):
    fresh host arrays re-packed into ``capacity`` rows plus the tenant
    placements that go with them. `adopt_prepared` flips the registry to it;
    ``source_generation`` pins the registry state it was built from (any
    mutation in between makes it stale and the flip refuses)."""

    bank_shards: int
    capacity: int
    source_generation: int
    arrays: dict  # _templates/_lower/_upper/_valid replacement arrays
    bucket_used: np.ndarray
    placements: list  # [(tenant_id, new_offset)]
    moved: int  # tenants whose offset changed


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TemplateBankRegistry:
    """Registry of per-tenant `TemplateBank`s stacked into one super-bank."""

    def __init__(self, num_features: int, *, k_max: int = 2,
                 class_bucket: int = 16, initial_classes: int = 128,
                 initial_tenants: int = 8, bank_shards: int = 1,
                 device=None):
        if initial_classes % class_bucket:
            raise ValueError("initial_classes must be a class_bucket multiple")
        if bank_shards < 1:
            raise ValueError("bank_shards must be >= 1")
        self.num_features = num_features
        self.k_max = k_max
        self.class_bucket = class_bucket
        self.device = resolve(device)
        self.bank_shards = bank_shards
        # capacity cuts into bank_shards equal shards of whole buckets (the
        # engine's PartitionPlan cuts class rows in C_cap/S chunks)
        align = bank_shards * class_bucket
        initial_classes = -(-initial_classes // align) * align
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

    def bank_of(self, tenant_id: str) -> TemplateBank:
        """The tenant's current bank read back out of the packed host
        arrays as (num_classes, k, N) numpy copies: the same bytes
        `device_bank()` serves in this tenant's window."""
        e = self.get(tenant_id)
        sl = slice(e.offset, e.offset + e.num_classes)
        return TemplateBank(
            templates=self._templates[sl, :e.k].copy(),
            lower=self._lower[sl, :e.k].copy(),
            upper=self._upper[sl, :e.k].copy(),
            valid=self._valid[sl, :e.k].copy(),
            thresholds=self._thr[e.slot].copy())

    @property
    def capacity_classes(self) -> int:
        return self._c_cap

    @property
    def capacity_tenants(self) -> int:
        return self._t_cap

    @property
    def rows_per_shard(self) -> int:
        """Class rows per bank shard (``C_cap`` when unsharded)."""
        return self._c_cap // self.bank_shards

    def stats(self) -> dict:
        return {
            "tenants": len(self._tenants),
            "generation": self.generation,
            "capacity_classes": self._c_cap,
            "capacity_tenants": self._t_cap,
            "used_class_buckets": int(self._bucket_used.sum()),
            "programmed_rows": int(self._valid.sum()),
            "bank_shards": self.bank_shards,
            "rows_per_shard": self.rows_per_shard,
        }

    def shard_rows_used(self) -> list[int]:
        """Allocated class rows per bank shard (bucket granularity), the
        fleet policy's capacity signal."""
        per_shard = self.rows_per_shard // self.class_bucket
        return [int(self._bucket_used[s * per_shard:(s + 1) * per_shard]
                    .sum()) * self.class_bucket
                for s in range(self.bank_shards)]

    # -- allocation ---------------------------------------------------------

    def _alloc_classes(self, n_buckets: int) -> int:
        """First-fit contiguous bucket run that never straddles a shard
        boundary; grows capacity (doubling) when fragmented or full, the
        only event that changes device shapes. Growth doubles the shard
        size, so new boundaries are a subset of the old ones."""
        while True:
            shard_buckets = self.rows_per_shard // self.class_bucket
            run = 0
            for i, used in enumerate(self._bucket_used):
                if i % shard_buckets == 0:
                    run = 0  # runs restart at every shard boundary
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

    # -- compaction ---------------------------------------------------------

    def _pack(self, entries, cap: int, bank_shards: int):
        """First-fit placement of existing bucket runs into a fresh bank of
        ``cap`` rows cut into ``bank_shards`` shards (runs restart at shard
        boundaries). Returns [(entry, new_offset)], or None when ``cap``
        cannot hold them."""
        shard_buckets = (cap // bank_shards) // self.class_bucket
        used = np.zeros(cap // self.class_bucket, bool)
        out = []
        for e in entries:
            n_buckets = e.c_bucket // self.class_bucket
            if n_buckets > shard_buckets:
                return None
            placed = None
            run = 0
            for i in range(len(used)):
                if i % shard_buckets == 0:
                    run = 0
                run = 0 if used[i] else run + 1
                if run == n_buckets:
                    start = i - n_buckets + 1
                    used[start:i + 1] = True
                    placed = start * self.class_bucket
                    break
            if placed is None:
                return None
            out.append((e, placed))
        return out

    def _build_shadow(self, cap: int, bank_shards: int) -> PreparedBank:
        """Copy every tenant's bucket run, in offset order, into FRESH
        arrays of ``cap`` rows (first fit, doubling ``cap`` until everyone
        fits). A pure read of the live bank."""
        order = sorted(self._tenants.values(), key=lambda e: e.offset)
        while (placement := self._pack(order, cap, bank_shards)) is None:
            cap *= 2
        arrays = {name: np.zeros((cap,) + getattr(self, name).shape[1:],
                                 getattr(self, name).dtype)
                  for name in ("_templates", "_lower", "_upper", "_valid")}
        bucket_used = np.zeros(cap // self.class_bucket, bool)
        moved = 0
        placements = []
        for entry, offset in placement:
            lo, hi = entry.offset, entry.offset + entry.c_bucket
            for name, arr in arrays.items():
                arr[offset:offset + entry.c_bucket] = \
                    getattr(self, name)[lo:hi]
            start = offset // self.class_bucket
            bucket_used[start:start + entry.c_bucket
                        // self.class_bucket] = True
            moved += offset != entry.offset
            placements.append((entry.tenant_id, offset))
        return PreparedBank(bank_shards=bank_shards, capacity=cap,
                            source_generation=self.generation,
                            arrays=arrays, bucket_used=bucket_used,
                            placements=placements, moved=moved)

    def prepare_reshard(self, bank_shards: int) -> PreparedBank:
        """Build the super-bank re-packed to ``bank_shards`` shards BESIDE
        the live one (the prepare half of the double-buffered reshard,
        `repro_torch.fleet.reshard`): the live bank keeps serving while
        this copies, and `adopt_prepared` flips to it between ticks. The
        buffer records the source generation, so a registry mutation after
        prepare makes it stale and the flip refuses it."""
        if bank_shards < 1:
            raise ValueError("bank_shards must be >= 1")
        align = bank_shards * self.class_bucket
        cap = -(-self._c_cap // align) * align
        return self._build_shadow(cap, bank_shards)

    def reshard(self, bank_shards: int) -> int:
        """Re-pack every tenant's bucket run to new shard boundaries
        without re-registering anyone: ids, slots, thresholds, head tables,
        template rows and `valid_rows` survive, only class offsets move
        (and capacity grows when the new alignment needs more rows).
        Returns the number of tenants whose offset changed. The control
        plane drains the scheduler first (`prepare_reshard` +
        `adopt_prepared` is the no-drain form)."""
        if bank_shards == self.bank_shards:
            return 0
        return self.adopt_prepared(self.prepare_reshard(bank_shards))

    def adopt_prepared(self, prepared: PreparedBank) -> int:
        """Flip to a shadow bank from `_build_shadow`: swap the host arrays
        and allocation map, move tenant offsets and bump the generation
        (`_bump`: the device bank and thresholds table are rebuilt at the
        new shape on their next read). Raises `RegistryError` when the
        registry changed since the shadow was built. Returns the number of
        tenants that moved."""
        if prepared.source_generation != self.generation:
            raise RegistryError(
                f"prepared bank is stale: built at generation "
                f"{prepared.source_generation}, registry is now at "
                f"{self.generation}; re-prepare")
        for name, arr in prepared.arrays.items():
            setattr(self, name, arr)
        self._bucket_used = prepared.bucket_used
        for tenant_id, offset in prepared.placements:
            entry = self._tenants[tenant_id]
            self._tenants[tenant_id] = dataclasses.replace(
                entry, offset=offset, generation=self.generation + 1)
        self._c_cap = prepared.capacity
        self.bank_shards = prepared.bank_shards
        self._bump()
        return prepared.moved

    def compact(self) -> int:
        """Shrink capacity after evictions: re-pack every tenant into the
        smallest shard-aligned capacity that holds them (capacity only ever
        doubles on register, and evict only frees buckets). `bank_of(t)`
        returns the same bytes before and after; only offsets move. Changes
        the device shapes. Returns the class rows freed (0: already
        minimal)."""
        align = self.bank_shards * self.class_bucket
        used = int(self._bucket_used.sum()) * self.class_bucket
        cap = max(align, -(-used // align) * align)
        if cap >= self._c_cap:
            return 0
        prepared = self._build_shadow(cap, self.bank_shards)
        if prepared.capacity >= self._c_cap:
            return 0  # fragmentation kept the pack from shrinking
        freed = self._c_cap - prepared.capacity
        self.adopt_prepared(prepared)
        return freed

    # -- durable state (service snapshot/restore) ---------------------------

    def snapshot_state(self) -> tuple[dict, dict]:
        """The registry's durable state as ``(arrays, meta)``: a flat dict
        of host numpy copies (an async checkpoint writer never races a hot
        register) and a JSON-serialisable dict of the scalars and tenant
        placements, in the JAX package's layout. `load_state` rebuilds this
        registry bit for bit from them."""
        arrays = {
            "templates": self._templates.copy(),
            "lower": self._lower.copy(),
            "upper": self._upper.copy(),
            "valid": self._valid.copy(),
            "thresholds": self._thr.copy(),
            "bucket_used": self._bucket_used.copy(),
            "slot_used": self._slot_used.copy(),
        }
        meta = {
            "num_features": self.num_features,
            "k_max": self.k_max,
            "class_bucket": self.class_bucket,
            "bank_shards": self.bank_shards,
            "capacity_classes": self._c_cap,
            "capacity_tenants": self._t_cap,
            "generation": self.generation,
            "tenants": [dataclasses.asdict(e)
                        for e in self._tenants.values()],
        }
        return arrays, meta

    def load_state(self, arrays: dict, meta: dict) -> None:
        """Adopt a `snapshot_state` payload wholesale (zero
        re-registrations), its shard count included. The bank-shape fields
        must match this registry's."""
        for field in ("num_features", "k_max", "class_bucket"):
            if meta[field] != getattr(self, field):
                raise RegistryError(
                    f"snapshot {field}={meta[field]} does not match this "
                    f"registry's {field}={getattr(self, field)}; restore "
                    "through a spec built from the snapshot")
        self._c_cap = int(meta["capacity_classes"])
        self._t_cap = int(meta["capacity_tenants"])
        self.bank_shards = int(meta["bank_shards"])
        self._templates = np.array(arrays["templates"], np.float32)
        self._lower = np.array(arrays["lower"], np.float32)
        self._upper = np.array(arrays["upper"], np.float32)
        self._valid = np.array(arrays["valid"], bool)
        self._thr = np.array(arrays["thresholds"], np.float32)
        self._bucket_used = np.array(arrays["bucket_used"], bool)
        self._slot_used = np.array(arrays["slot_used"], bool)
        self._tenants = {d["tenant_id"]: TenantEntry(**d)
                         for d in meta["tenants"]}
        self.generation = int(meta["generation"])
        self._bump()  # drop caches; device views rebuild from the new bytes

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
