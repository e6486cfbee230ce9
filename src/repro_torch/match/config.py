"""Engine configuration: one hashable value object per matching setup.

The fields and their order are the JAX package's, so a `ServiceSpec`
serialises to the same JSON in both packages:

  method   "feature_count" (Eq. 8) or "similarity" (Eq. 9-11)
  alpha    Eq. 11 distance weight (similarity method only)
  backend  "auto" | "reference" | "kernel" (or any registered name);
           "auto" is "kernel" on the card
  block    the Pallas block override of the JAX package; the CUDA kernels
           take no block, so the port carries it for the spec and ignores it
  margin   `MatchEngine.__call__` returns (pred, per_class, margin)
  device   `ACAMConfig` for the device-physics backend (later slice)
  seed     PRNG seed for programming noise (device backend, later slice)
  device_noise   "global" | "per_shard" (device backend, later slice)
  serve_fusion   how the kernel backend runs the serving tick: "mega" (one
           kernel, `acam_match_serve`) or "compose" (gather + shift in
           PyTorch, then the margins kernel, then the tau compare) — the
           bit-identical baseline
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.acam import ACAMConfig

METHODS = ("feature_count", "similarity")

DEVICE_NOISE_MODES = ("global", "per_shard")

SERVE_FUSION_MODES = ("mega", "compose")


class EngineConfig(NamedTuple):
    method: str = "feature_count"
    alpha: float = 1.0
    backend: str = "auto"
    block: tuple[int, int, int] | None = None
    margin: bool = False
    device: ACAMConfig | None = None
    seed: int = 0
    device_noise: str = "global"
    serve_fusion: str = "mega"


def validate(config: EngineConfig, backend_names: tuple[str, ...]) -> None:
    """Raise ValueError for unknown methods/backends/modes (the JAX
    package's messages)."""
    if config.method not in METHODS:
        raise ValueError(f"unknown matching method {config.method}")
    if config.backend != "auto" and config.backend not in backend_names:
        raise ValueError(
            f"unknown matching backend {config.backend!r}; use "
            f"{('auto',) + backend_names}")
    if config.block is not None and len(tuple(config.block)) != 3:
        raise ValueError(f"block must be (bm, bn, bk), got {config.block!r}")
    if config.device_noise not in DEVICE_NOISE_MODES:
        raise ValueError(f"unknown device_noise {config.device_noise!r}; "
                         f"use {DEVICE_NOISE_MODES}")
    if config.serve_fusion not in SERVE_FUSION_MODES:
        raise ValueError(f"unknown serve_fusion {config.serve_fusion!r}; "
                         f"use {SERVE_FUSION_MODES}")
    hash(config)  # configs key the engine cache
