"""The LM zoo's architecture configs, as the JAX package's `repro.configs`
has them, building the port's `ArchConfig`.

Each module exports CONFIG (full) and SMOKE (reduced, same family and
features). `get(name)` / `list_archs()` are the registry the launcher uses
for ``--arch``; the model serves all ten.
"""
from __future__ import annotations

import importlib

from repro_torch.models.lm import ArchConfig

ARCH_IDS = [
    "qwen2_5_14b",
    "tinyllama_1_1b",
    "qwen3_1_7b",
    "qwen1_5_32b",
    "phi3_5_moe",
    "deepseek_v3",
    "qwen2_vl_72b",
    "hymba_1_5b",
    "hubert_xlarge",
    "mamba2_2_7b",
]

# canonical ids from the assignment brief -> module names
ALIASES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "deepseek-v3-671b": "deepseek_v3",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "hymba-1.5b": "hymba_1_5b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-2.7b": "mamba2_2_7b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str, smoke: bool = False) -> ArchConfig:
    mod = _module(name)
    return mod.SMOKE if smoke else mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCH_IDS)
