"""repro_torch.match — the pluggable template-matching engine.

    callers   repro_torch.core.hybrid (ACAMHead / HybridClassifier)
              repro_torch.serve.{registry, scheduler, acam_service}
                 |
    engine    MatchEngine(EngineConfig)   one hashable config
                 |
    backends  reference (plain PyTorch oracles) | kernel (the CUDA kernels
              of repro_torch.kernels) | device (repro_torch.core.acam
              RRAM-CMOS physics)
"""
from repro_torch.match.backends import (MAX_FUSED_ROWS, TINY_ELEMENTS,
                                        TINY_ELEMENTS_SIMILARITY,
                                        DeviceBackend, KernelBackend,
                                        MatchBackend, ReferenceBackend,
                                        backend_for, backend_names,
                                        classify_scores,
                                        feature_count_scores_ref,
                                        register_backend,
                                        similarity_scores_ref, tiny_cutoff,
                                        window_margin, winner_take_all)
from repro_torch.match.config import EngineConfig
from repro_torch.match.engine import (MatchEngine, default_backend,
                                      engine_for, engine_from_config,
                                      set_default_backend, use_backend)

__all__ = [
    "MAX_FUSED_ROWS", "TINY_ELEMENTS", "TINY_ELEMENTS_SIMILARITY",
    "DeviceBackend", "KernelBackend", "MatchBackend", "ReferenceBackend",
    "backend_for", "backend_names", "classify_scores",
    "feature_count_scores_ref", "register_backend",
    "similarity_scores_ref", "tiny_cutoff",
    "window_margin", "winner_take_all", "EngineConfig", "MatchEngine",
    "default_backend", "engine_for", "engine_from_config",
    "set_default_backend", "use_backend",
]
