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
"""
from __future__ import annotations

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
    """Drop the installed mesh and any forced device list."""
    global _AXES, _MESH, _FORCED, _GENERATION
    _AXES = None
    _MESH = None
    _FORCED = None
    _GENERATION += 1


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
