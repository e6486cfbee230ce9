"""Meshes: the port's `repro.launch.mesh` (`make_production_mesh`,
`make_host_mesh`, `make_serving_mesh`).

A function, not a module-level constant, so importing this module touches
no device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.distributed import context


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> context.Mesh:
    """The pod mesh (data=16, model=16); two pods add a leading "pod"
    axis: (pod=2, data=16, model=16). Built over `context.devices(device)`
    (every card, or a forced mesh's repeated device); raises unless that
    many devices exist."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = context.devices(device)
    need = int(np.prod(shape))
    if len(devs) < need:
        raise ValueError(f"the production mesh {shape} needs {need} "
                         f"devices; {len(devs)} are available (a forced "
                         "mesh, REPRO_FORCE_MESH, provides them on one card)")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return context.Mesh(grid.reshape(shape), axes)


def make_host_mesh(device="cpu") -> context.Mesh:
    """Single-device mesh (axes kept for spec parity)."""
    return context.Mesh([[device]], ("data", "model"))


def make_serving_mesh(*, bank_shards: int = 1,
                      axis_names: tuple[str, str] = ("data", "model"),
                      devices=None, device=None) -> context.Mesh:
    """(data = devices/bank_shards, model = bank_shards) over the available
    devices: the ACAM serving layout, request batches over "data", the
    template super-bank's class rows over "model" (the engine's
    `repro_torch.match.plan.PartitionPlan`). ``bank_shards=1`` is pure data
    parallelism (bank replicated).

    ``devices`` restricts the mesh to an explicit device list (the
    survivors after a device loss, `HybridService.handle_device_loss`);
    default: `context.devices(device)`, every card, or a forced mesh's
    repeated device. Two shards never share a device unless a forced mesh
    asked for it: on one card without one, ``bank_shards=2`` raises.
    """
    devs = context.devices(device) if devices is None else list(devices)
    ndev = len(devs)
    if bank_shards < 1 or ndev % bank_shards:
        raise ValueError(
            f"bank_shards={bank_shards} must divide the {ndev} available "
            "devices")
    grid = np.empty((ndev // bank_shards, bank_shards), dtype=object)
    for i, d in enumerate(devs):
        grid[i // bank_shards, i % bank_shards] = d
    return context.Mesh(grid, tuple(axis_names))
