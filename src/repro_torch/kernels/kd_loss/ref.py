"""Plain-PyTorch oracle of the kd_loss kernel: the per-sample Eq. 1 loss in
f32 through log-softmaxes, as the JAX package's `kd_loss_ref` writes it
(the CE term gathers the label's log-probability, so labels must lie in
``[0, V)``)."""
from __future__ import annotations

import torch


def kd_loss_ref(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                labels: torch.Tensor, *, temperature: float = 4.0,
                alpha: float = 0.5) -> torch.Tensor:
    zs = student_logits.to(torch.float32)
    zt = teacher_logits.to(torch.float32)
    log_ps = torch.log_softmax(zs / temperature, dim=-1)
    pt = torch.softmax(zt / temperature, dim=-1)
    log_pt = torch.log_softmax(zt / temperature, dim=-1)
    kl = torch.sum(pt * (log_pt - log_ps), dim=-1)
    logp = torch.log_softmax(zs, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return alpha * temperature**2 * kl + (1 - alpha) * ce
