"""Knowledge distillation (paper §II-A, Eq. 1-4), in plain PyTorch.

Teacher-student framework with:
  - composite loss   L = alpha * L_KD(z_s, z_t) + (1 - alpha) * L_CE(z_s, y)   (Eq. 1)
  - KD loss          L_KD = T^2 * KL( sigma(z_t/T) || sigma(z_s/T) )            (Eq. 2-3)
    in the standard (Hinton) direction KL(teacher || student), as the JAX
    package computes it;
  - curriculum learning: samples ordered by teacher difficulty
    d(x, y) = CE(z_t(x), y)                                                    (Eq. 4)

These are the trainer's losses (differentiable). The fused per-sample loss
kernel (B8, `repro_torch.kernels.kd_loss`) computes Eq. 1 forward only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def softmax_t(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """Temperature-scaled softmax (Eq. 3)."""
    return torch.softmax(logits / temperature, dim=-1)


def log_softmax_t(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.log_softmax(logits / temperature, dim=-1)


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """Eq. 2: T^2 * KL(p_t || p_s), mean over batch."""
    log_p_s = log_softmax_t(student_logits, temperature)
    p_t = softmax_t(teacher_logits, temperature)
    log_p_t = log_softmax_t(teacher_logits, temperature)
    kl = torch.sum(p_t * (log_p_t - log_p_s), dim=-1)
    return (temperature**2) * torch.mean(kl)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Standard CE with integer labels, mean over batch."""
    return torch.mean(_nll(logits, labels))


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, labels: torch.Tensor, *,
                      alpha: float = 0.5, temperature: float = 4.0
                      ) -> torch.Tensor:
    """Eq. 1 composite loss."""
    return alpha * kd_loss(student_logits, teacher_logits, temperature) + (
        1.0 - alpha) * cross_entropy(student_logits, labels)


def per_sample_difficulty(teacher_logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Eq. 4: d(x_i, y_i) = CE(z_t(x_i), y_i), per sample (no reduction)."""
    return _nll(teacher_logits, labels)


def curriculum_order(teacher_logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Indices sorting the training set easiest -> hardest (paper §II-A);
    a stable sort, so equal difficulties keep their index order, as
    `jnp.argsort` does."""
    return torch.argsort(per_sample_difficulty(teacher_logits, labels),
                         stable=True)


class CurriculumSchedule(NamedTuple):
    """Pacing function: at epoch e (of n), train on the easiest frac(e) part.

    A linear pacing from `start_frac` to 1.0 — the paper orders data easy to
    hard 'allowing the student to gradually progress'.
    """

    start_frac: float = 0.3
    warmup_epochs: int = 5

    def available(self, epoch: int, n_samples: int) -> int:
        frac = min(
            1.0,
            self.start_frac
            + (1.0 - self.start_frac) * (epoch / max(self.warmup_epochs, 1)),
        )
        return max(1, int(frac * n_samples))
