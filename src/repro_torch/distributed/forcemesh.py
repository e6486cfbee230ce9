"""REPRO_FORCE_MESH: forced meshes for tests, benches and one-card runs.

``REPRO_FORCE_MESH=DxM`` (e.g. ``2x2``) asks a process to serve on a mesh
of D data-parallel x M model (bank-shard) devices, so the engine's 2D
`PartitionPlan` (batch over "data", template-bank class rows over "model")
runs end to end on one device. The JAX package gets D*M host devices from
an XLA flag that must be set before jax starts; the port needs no flag: a
forced mesh is one physical device repeated D*M times
(`repro_torch.distributed.context.Mesh.virtual`), the CPU in the tests and
the card in the smoke run. Nothing installs a mesh at import.

    from repro_torch.distributed import forcemesh
    forcemesh.install((1, 2), device="cpu")    # or REPRO_FORCE_MESH=1x2
    ...
    context.clear()                            # drop it again
"""
from __future__ import annotations

import os

ENV = "REPRO_FORCE_MESH"


def parse(spec: str) -> tuple[int, int]:
    """"2x2" -> (data=2, model=2); raises ValueError on malformed specs."""
    try:
        d, m = spec.lower().split("x")
        d, m = int(d), int(m)
    except ValueError:
        raise ValueError(
            f"{ENV} must look like 'DxM' (e.g. 2x2), got {spec!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"{ENV} axes must be >= 1, got {spec!r}")
    return d, m


def env_spec() -> tuple[int, int] | None:
    """The (data, model) shape requested via the environment, or None."""
    spec = os.environ.get(ENV, "").strip()
    return parse(spec) if spec else None


def install(spec: tuple[int, int] | None = None, *, device=None):
    """Build the (data=D, model=M) mesh of ``device`` (the card unless the
    caller asks for the CPU) repeated D*M times, make it the device list
    `context.devices()` answers, and install it. ``spec`` defaults to
    ``REPRO_FORCE_MESH``. Returns the mesh, or None when no forced mesh is
    requested."""
    from repro_torch.device import resolve
    from repro_torch.distributed import context

    spec = spec if spec is not None else env_spec()
    if spec is None:
        return None
    d, m = spec
    if d < 1 or m < 1:
        raise ValueError(f"{ENV} axes must be >= 1, got {d}x{m}")
    dev = resolve(device)
    devs = [dev] * (d * m)
    mesh = context.Mesh([devs[i * m:(i + 1) * m] for i in range(d)],
                        ("data", "model"))
    context.force_devices(devs)
    context.set_mesh_axes("data", "model", mesh)
    return mesh
