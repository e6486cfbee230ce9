"""Process-wide mesh context: the port's `jax.sharding.Mesh` and
`repro.distributed.context`.

The JAX package is single-controller: one process calls `shard_map` over a
mesh of devices. The port keeps that shape in one process: a `Mesh` is a
(data, model) grid of `torch.device`s, the engine cuts each call's batch
over "data" and the template bank's class rows over "model", launches each
tile's kernel on its tile's device, and merges the partials itself
(`repro_torch.match.engine`). Launchers install the mesh here; with none
installed every call runs replicated on its operands' device.

A *forced* mesh (`repro_torch.distributed.forcemesh`) fills the grid with
one physical device repeated: the CPU in the tests, the card in the smoke
run. Such a mesh is `Mesh.virtual`: its shards run one after another on
the same device. On a machine with several cards the grid holds
``cuda:0 .. cuda:{n-1}`` and shard s runs on its own card.

The LM's hooks keep the JAX contract: `constrain` is the identity on
values (and a no-op with no mesh), and `constrain_layer` /
`constrain_head` apply the ZeRO-3 gather-at-use constraint that
`repro_torch.distributed.sharding.register_zero3_constraints` installs.
On the port's single controller a layer's parameters may be sharded
tensors (`sharding.ShardedTensor`); while a mesh step runs a data
coordinate (`data_shard`), the same two calls then place each one whole
on that coordinate's device, where the dense products run (see
`repro_torch.distributed.sharding`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class MeshAxes(NamedTuple):
    dp: tuple | str  # data-parallel axes ("data" or ("pod", "data"))
    model: str


class Mesh:
    """A grid of `torch.device`s with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names`` and ``shape``)."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.array(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs "
                             f"{grid.ndim} axis names, got {axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(grid)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def virtual(self) -> bool:
        """True when two grid entries are one physical device (a forced
        mesh): the shards then share that device and run in turn."""
        flat = [str(d) for d in self.devices.flat]
        return len(set(flat)) < len(flat)

    def ranks(self, dp, model: str = "model") -> list[list[tuple]]:
        """Grid coordinates by (data-parallel index, model index): the dp
        index runs over the ``dp`` axes (one name or a tuple) with the
        first one major, as a ``P(("pod", "data"))`` block order does."""
        dp = dp if isinstance(dp, tuple) else (dp,)
        names = self.axis_names
        dims = [self.shape[a] for a in dp]
        out = []
        for flat in np.ndindex(*dims):
            row = []
            for j in range(self.shape[model]):
                at = dict(zip(dp, flat), **{model: j})
                row.append(tuple(at.get(a, 0) for a in names))
            out.append(row)
        return out

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"Mesh({shape}, devices={devs}"
                f"{', virtual' if self.virtual else ''})")


_AXES: MeshAxes | None = None
_MESH: Mesh | None = None
_FORCED: list[torch.device] | None = None
_GENERATION = 0


def set_mesh_axes(dp, model: str = "model", mesh: Mesh | None = None
                  ) -> None:
    global _AXES, _MESH, _GENERATION
    _AXES = MeshAxes(dp, model)
    _MESH = mesh
    _GENERATION += 1


def get_mesh() -> Mesh | None:
    return _MESH


def get() -> MeshAxes | None:
    return _AXES


def generation() -> int:
    """Monotonic mesh-change counter, bumped by `set_mesh_axes` / `clear`:
    callers that cache a decision taken under one mesh key it on this."""
    return _GENERATION


def clear() -> None:
    """Drop the installed mesh, any forced device list and the layer and
    head hooks."""
    global _AXES, _MESH, _FORCED, _GENERATION, _LAYER_CONSTRAINT
    global _HEAD_CONSTRAINT
    _AXES = None
    _MESH = None
    _FORCED = None
    _LAYER_CONSTRAINT = None
    _HEAD_CONSTRAINT = None
    _GENERATION += 1


def constrain(x, *spec):
    """A sharding constraint on an activation: the identity on values, and
    a no-op with no mesh installed. The port's mesh steps run each data
    coordinate's rows whole on its device, so there is nothing to move.
    ``spec`` entries are "dp", "model" or None, as in the JAX package."""
    return x


# --- ZeRO-3 gather-at-use --------------------------------------------------
# FSDP-stored weights are gathered to their tensor-parallel compute
# sharding where a layer (or the head) uses them; the step builders
# register the constraint and model code applies it at layer entry.

_LAYER_CONSTRAINT = None
_HEAD_CONSTRAINT = None


def set_layer_constraint(fn) -> None:
    global _LAYER_CONSTRAINT
    _LAYER_CONSTRAINT = fn


def set_head_constraint(fn) -> None:
    global _HEAD_CONSTRAINT
    _HEAD_CONSTRAINT = fn


def constrain_layer(layer_params):
    """The layer hook, then (inside a mesh step) the layer's sharded
    tensors placed whole on the running data coordinate's device."""
    p = _LAYER_CONSTRAINT(layer_params) if _LAYER_CONSTRAINT else \
        layer_params
    return _SHARD.place(p) if _SHARD is not None else p


def constrain_head(head_params):
    """The head hook (``embed``, ``unembed``, ``final_norm``), then placed
    as `constrain_layer` places a layer."""
    p = _HEAD_CONSTRAINT(head_params) if _HEAD_CONSTRAINT else head_params
    return _SHARD.place(p) if _SHARD is not None else p


# --- the data coordinate a mesh step is running -----------------------------

@dataclasses.dataclass
class DataShard:
    """One data-parallel coordinate of a mesh step (single controller).

    ``index`` is its dp index and ``ranks`` the grid coordinates of its
    model ranks (`Mesh.ranks`); it computes on ``device``, its model rank
    0's. ``tokens`` is the step's global token count and ``place`` the
    function that puts a module's sharded tensors on ``device``. The MoE
    layers record their routing statistics here (``moe``: layer -> (expert
    counts, summed router probabilities, the loss's coefficient) over this
    coordinate's tokens),
    so the step can take the load-balance loss over the global batch, and
    read ``prefix`` (layer -> the expert counts of the coordinates before
    this one) to keep the global capacity's drops."""

    index: int
    mesh: Mesh
    ranks: list
    tokens: int
    place: object
    moe: dict = dataclasses.field(default_factory=dict)
    prefix: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.ranks[0]]


_SHARD: DataShard | None = None


@contextlib.contextmanager
def running(shard: DataShard):
    """Run a mesh step's data coordinate: model code reads `data_shard`."""
    global _SHARD
    prev, _SHARD = _SHARD, shard
    try:
        yield shard
    finally:
        _SHARD = prev


def data_shard() -> DataShard | None:
    return _SHARD


def force_devices(devs: list[torch.device] | None) -> None:
    """Make `devices()` answer ``devs`` (a forced mesh's repeated device)
    until `clear`; `repro_torch.distributed.forcemesh.install` calls it."""
    global _FORCED
    _FORCED = None if devs is None else [torch.device(d) for d in devs]


def devices(device=None) -> list[torch.device]:
    """The port's ``jax.devices()``: the devices a serving mesh may be built
    over.

    The forced list when a forced mesh was installed
    (`forcemesh.install`); else, when ``REPRO_FORCE_MESH=DxM`` is set, D*M
    copies of ``device`` (the card by default); else every CUDA card, or
    ``[cpu]`` when ``device`` is the CPU. Raises with no card unless the
    caller asked for the CPU (`repro_torch.device.resolve`).
    """
    from repro_torch.device import resolve
    from repro_torch.distributed import forcemesh

    if _FORCED is not None:
        return list(_FORCED)
    dev = resolve(device)
    spec = forcemesh.env_spec()
    if spec is not None:
        return [dev] * (spec[0] * spec[1])
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
