"""PartitionPlan: how one matching call maps onto the installed mesh.

The port of `repro.match.plan`. A `PartitionPlan` is a small hashable
value, derived at the call boundary from the mesh in
`repro_torch.distributed.context` and the call's shapes, that says how one
matching call executes:

    batch  cut over the dp axes    (when the batch divides the dp devices)
    bank   class rows cut over the model axis
           (when C divides the model-axis size and the backend supports it)
    both   2D: each device holds a (B / dp, C / shards) tile of the problem

Every device computes Eq. 8/11 scores and the per-class Eq. 12 partial max
on its class-row shard; one small cross-shard ``(max, argmax)`` merge
recovers the exact global decision and the windowed winner-vs-runner-up
margin, bit-identically to replicated execution (ties resolve to the lowest
global class index, as `torch.argmax` and `jnp.argmax` do).

The JAX plan's ``PartitionSpec`` builders become the slices they stand
for: `batch_slice` (the batch rows of dp index d) and `class_slice` (the
class rows ``[s * rows_per_shard, (s + 1) * rows_per_shard)`` of shard s).

Who consumes the plan:

    repro_torch.match.engine        cuts the call, merges the partials
    repro_torch.serve.registry      aligns tenant buckets to shard edges
    repro_torch.serve.acam_service  infers ``bank_shards`` from the mesh
    repro_torch.launch.serve        installs the mesh (``--bank-shards``)
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

#: below this many bank shards the sequential all-gather fold is the
#: default: the butterfly's log2(S) exchange rounds cost more latency than
#: gathering S tiny rows; at S >= 8 the tree's O(log S) depth takes over.
TREE_REDUCE_MIN_SHARDS = 8

REDUCE_STRATEGIES = ("allgather", "tree")


class PartitionPlan(NamedTuple):
    """How one matching call is partitioned over the installed mesh.

    dp:             mesh axis names the batch is cut over (() = batch
                    replicated / single device)
    model:          mesh axis name the bank's class rows are cut over
                    (None = bank replicated on every device)
    dp_devices:     product of the dp axis sizes (1 when uncut)
    bank_shards:    model-axis size (1 when the bank is replicated)
    rows_per_shard: class rows per bank shard, C // bank_shards (0 when the
                    bank is replicated): shard s owns global class rows
                    [s * rows_per_shard, (s + 1) * rows_per_shard)
    reduce:         cross-shard merge: "allgather" (all S partials, folded
                    in shard order) or "tree" (XOR butterfly, log2(S)
                    rounds). Both give the same bits: the merge is
                    associative on disjoint index ranges and f32 max is
                    exact.
    """

    dp: tuple[str, ...] = ()
    model: str | None = None
    dp_devices: int = 1
    bank_shards: int = 1
    rows_per_shard: int = 0
    reduce: str = "allgather"

    @property
    def batch_sharded(self) -> bool:
        return self.dp_devices > 1

    @property
    def bank_sharded(self) -> bool:
        return self.bank_shards > 1

    @property
    def sharded(self) -> bool:
        return self.batch_sharded or self.bank_sharded

    def batch_slice(self, batch: int, d: int) -> slice:
        """The batch rows dp index ``d`` holds."""
        rows = batch // self.dp_devices
        return slice(d * rows, (d + 1) * rows)

    def class_slice(self, s: int) -> slice:
        """The class rows bank shard ``s`` holds (all rows when the bank is
        replicated)."""
        if not self.bank_sharded:
            return slice(None)
        return slice(s * self.rows_per_shard,
                     (s + 1) * self.rows_per_shard)


#: the no-mesh / no-divisibility plan: run the backend directly.
REPLICATED = PartitionPlan()


def reduce_strategy(bank_shards: int) -> str:
    """Pick the cross-shard merge for a model axis of ``bank_shards``.

    Default: the XOR-butterfly tree when the shard count is a power of two
    at or past `TREE_REDUCE_MIN_SHARDS`, the sequential all-gather fold
    otherwise. The butterfly pairs rank s with s ^ d, so it needs a
    power-of-two axis.

    ``REPRO_REDUCE_STRATEGY=tree|allgather`` overrides the default; "tree"
    still falls back to the fold on an axis that is not a power of two.
    """
    pow2 = bank_shards > 1 and (bank_shards & (bank_shards - 1)) == 0
    env = os.environ.get("REPRO_REDUCE_STRATEGY", "").strip().lower()
    if env in REDUCE_STRATEGIES:
        return env if env != "tree" or pow2 else "allgather"
    if pow2 and bank_shards >= TREE_REDUCE_MIN_SHARDS:
        return "tree"
    return "allgather"


def mesh_axes():
    """(mesh, MeshAxes) from the distributed context, or (None, None)."""
    from repro_torch.distributed import context

    mesh = context.get_mesh()
    axes = context.get()
    if mesh is None or axes is None:
        return None, None
    return mesh, axes


def plan_for(*, batch: int, num_classes: int,
             bank_shardable: bool = True):
    """The plan for a call of these shapes: returns ``(plan, mesh)``.

    The batch is cut over the dp axes iff it divides their device product;
    the bank's class rows over the model axis iff C divides the model-axis
    size and the backend supports a cut bank
    (`MatchBackend.supports_bank_sharding`: the device-physics backend
    declines under "global" ``sigma_program > 0`` noise, where splitting
    the programming draw would change the realised noise layout).
    """
    mesh, axes = mesh_axes()
    if mesh is None:
        return REPLICATED, None
    dp_axes = axes.dp if isinstance(axes.dp, tuple) else (axes.dp,)
    dp: tuple[str, ...] = ()
    dp_devices = 1
    if all(a in mesh.axis_names for a in dp_axes):
        n = math.prod(mesh.shape[a] for a in dp_axes)
        if n > 1 and batch % n == 0:
            dp, dp_devices = tuple(dp_axes), n
    model = None
    bank_shards = 1
    rows = 0
    if bank_shardable and axes.model in mesh.axis_names:
        s = mesh.shape[axes.model]
        if s > 1 and num_classes % s == 0:
            model, bank_shards, rows = axes.model, s, num_classes // s
    plan = PartitionPlan(dp=dp, model=model, dp_devices=dp_devices,
                         bank_shards=bank_shards, rows_per_shard=rows,
                         reduce=reduce_strategy(bank_shards))
    if not plan.sharded:
        return REPLICATED, None
    return plan, mesh


def bank_shards_in_mesh() -> int:
    """Model-axis size of the installed mesh (1 when none is installed):
    the serving tier aligns the registry's class buckets to it."""
    mesh, axes = mesh_axes()
    if mesh is None or axes.model not in mesh.axis_names:
        return 1
    return int(mesh.shape[axes.model])
