"""Public entry point of the kd_loss kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.kd_loss.kd_loss import DEFAULT_BLOCK, kd_loss


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, labels: torch.Tensor, *,
                      temperature: float = 4.0, alpha: float = 0.5,
                      block=DEFAULT_BLOCK) -> torch.Tensor:
    """Mean fused KD loss (paper Eq. 1), a f32 scalar. Accepts (B, V) or
    (B, S, V) logits with (B,) or (B, S) labels; runs where the logits lie
    (the B8 kernel on the card, its plain version on the CPU)."""
    zs, zt, y = student_logits, teacher_logits, labels
    if zs.dim() == 3:
        zs = zs.reshape(-1, zs.shape[-1])
        zt = zt.reshape(-1, zt.shape[-1])
        y = y.reshape(-1)
    per = kd_loss(zs, zt, y, temperature=temperature, alpha=alpha,
                  block=block)
    return torch.mean(per)
