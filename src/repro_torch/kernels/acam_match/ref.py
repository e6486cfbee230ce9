"""Plain PyTorch oracle for the acam_match kernels (paper Eq. 8)."""
from __future__ import annotations

import torch


def acam_match_ref(features: torch.Tensor, thresholds: torch.Tensor,
                   templates: torch.Tensor) -> torch.Tensor:
    """(B, M) count of agreeing features: S = sum_i 1(Q_i == T_i)."""
    q = (features > thresholds[None, :]).to(torch.float32)
    eq = q[:, None, :] == templates[None, :, :]
    return eq.sum(dim=-1).to(torch.float32)
