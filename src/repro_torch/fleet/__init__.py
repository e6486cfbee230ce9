"""`repro_torch.fleet`: the self-driving deployment layer.

  * `manifest`: `FleetManifest`, the tenant population as one hashable,
    JSON-round-trippable value; `HybridService.apply_manifest` diffs it
    like `reconfigure` diffs specs.
  * `policy`: `decide(view) -> ServiceSpec`, a pure controller from a
    frozen telemetry snapshot to the next spec, and `should_compact`.
  * `autopilot`: the impure loop (cadence, hysteresis, cooldown),
    executing through `reconfigure`, the rolling reshard and
    `compact_registry`.
  * `reshard`: the double-buffered rolling reshard, the re-packed
    super-bank built beside the live one and flipped between ticks (one
    generation bump, no queue drain), the same results as the drained
    path.
"""
from repro_torch.fleet.autopilot import Autopilot
from repro_torch.fleet.manifest import (FleetManifest, ManifestDiff,
                                        ManifestError, TenantSpec,
                                        diff_manifests, load_bank,
                                        materialize, save_bank,
                                        tau_in_units)
from repro_torch.fleet.policy import (PolicySpec, RegistryView, decide,
                                      explain, should_compact, view_of)
from repro_torch.fleet.reshard import PreparedReshard, flip, prepare

__all__ = [
    "Autopilot", "FleetManifest", "ManifestDiff", "ManifestError",
    "TenantSpec", "diff_manifests", "load_bank", "materialize",
    "save_bank", "tau_in_units", "PolicySpec", "RegistryView", "decide",
    "explain", "should_compact", "view_of", "PreparedReshard", "flip",
    "prepare",
]
