"""Public entry point of the flash attention kernel: GQA-aware attention on
model-layout tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    DEFAULT_BLOCK, flash_attention_gqa)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, block=DEFAULT_BLOCK) -> torch.Tensor:
    """(B, S, H, D) x (B, S, KV, D) -> (B, S, H, D); runs where q lies (the
    B9 kernel on the card, reading kv head h / (H / KV) in place; its plain
    version on the CPU). ``block`` is accepted for signature parity."""
    return flash_attention_gqa(q, k, v, causal=causal)
