"""repro_torch.match — the pluggable, mesh-aware template-matching engine.

    callers   repro_torch.core.hybrid (ACAMHead / HybridClassifier)
              repro_torch.serve.{registry, scheduler, acam_service}
              repro_torch.launch.serve --workload acam --bank-shards
                 |
    engine    MatchEngine(EngineConfig)   one hashable config
                 |
    plan      PartitionPlan(mesh, shapes): batch over the dp axes, bank
              class rows over the model axis, or both; the cross-shard
              (max, argmax) merge keeps decisions and margins bit-identical
              to replicated execution
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
                                        register_backend, shard_window_top2,
                                        similarity_scores_ref, tiny_cutoff,
                                        window_margin, winner_take_all)
from repro_torch.match.config import EngineConfig
from repro_torch.match.engine import (MatchEngine, default_backend,
                                      dp_axes_in_mesh, engine_for,
                                      engine_from_config,
                                      set_default_backend, use_backend)
from repro_torch.match.plan import (REPLICATED, TREE_REDUCE_MIN_SHARDS,
                                    PartitionPlan, bank_shards_in_mesh,
                                    plan_for, reduce_strategy)

__all__ = [
    "MAX_FUSED_ROWS", "TINY_ELEMENTS", "TINY_ELEMENTS_SIMILARITY",
    "DeviceBackend", "KernelBackend", "MatchBackend", "ReferenceBackend",
    "backend_for", "backend_names", "classify_scores",
    "feature_count_scores_ref", "register_backend", "shard_window_top2",
    "similarity_scores_ref", "tiny_cutoff",
    "window_margin", "winner_take_all", "EngineConfig", "MatchEngine",
    "default_backend", "dp_axes_in_mesh", "engine_for",
    "engine_from_config", "set_default_backend", "use_backend",
    "REPLICATED", "TREE_REDUCE_MIN_SHARDS", "PartitionPlan",
    "bank_shards_in_mesh", "plan_for", "reduce_strategy",
]
