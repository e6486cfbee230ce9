"""`repro_torch.fleet`: the self-driving deployment layer, on one card.

  * `manifest`: `FleetManifest`, the tenant population as one hashable,
    JSON-round-trippable value; `HybridService.apply_manifest` diffs it
    like `reconfigure` diffs specs.
  * `policy`: `decide(view) -> ServiceSpec`, a pure controller from a
    frozen telemetry snapshot to the next spec, and `should_compact`.
  * `autopilot`: the impure loop (cadence, hysteresis, cooldown),
    executing through `reconfigure` and `compact_registry`.

The JAX package's `fleet.reshard` (the double-buffered rolling reshard)
comes with the multi-GPU slice of the port.
"""
from repro_torch.fleet.autopilot import Autopilot
from repro_torch.fleet.manifest import (FleetManifest, ManifestDiff,
                                        ManifestError, TenantSpec,
                                        diff_manifests, load_bank,
                                        materialize, save_bank,
                                        tau_in_units)
from repro_torch.fleet.policy import (PolicySpec, RegistryView, decide,
                                      explain, should_compact, view_of)

__all__ = [
    "Autopilot", "FleetManifest", "ManifestDiff", "ManifestError",
    "TenantSpec", "diff_manifests", "load_bank", "materialize",
    "save_bank", "tau_in_units", "PolicySpec", "RegistryView", "decide",
    "explain", "should_compact", "view_of",
]
