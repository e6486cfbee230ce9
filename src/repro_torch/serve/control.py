"""The hybrid service's control plane: build from one spec.

`HybridService.from_spec(spec, device=None)` validates the spec and builds
registry -> scheduler -> cascade in order on ``device`` (the card unless the
caller asks for the CPU). Live transitions (`reconfigure`), snapshots,
device-loss failover and fleet manifests come with later slices of the
port.
"""
from __future__ import annotations

from repro_torch.device import resolve
from repro_torch.serve.acam_service import ACAMService
from repro_torch.serve.spec import ServiceSpec


class HybridService(ACAMService):
    """`ACAMService` behind the declarative front door."""

    @classmethod
    def from_spec(cls, spec: ServiceSpec, *, device=None) -> "HybridService":
        """Validate the spec, then build registry -> scheduler -> cascade."""
        spec.validate()
        svc = cls.__new__(cls)
        svc._build(spec, resolve(device))
        return svc
