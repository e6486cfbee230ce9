"""Quantisation schemes (paper §II-C), forward only.

  1. 8-bit symmetric per-tensor fake-quant for model weights (QAT /
     deployment). The straight-through gradient comes with the training
     path.
  2. Binary (1-bit) feature-map quantisation for ACAM deployment against a
     *mean-based* per-feature threshold (Fig. 1).

`torch.round`, like `jnp.round`, rounds half to even, so the int8 grid is
the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Literal

import torch


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    amax = torch.clamp(w.abs().max(), min=1e-8)
    scale = amax / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant_int8(w: torch.Tensor) -> torch.Tensor:
    """Round weights onto the int8 grid (forward only)."""
    return dequantize_int8(*quantize_int8(w))


def fake_quant_tree(params: dict, *, predicate=None) -> dict:
    """Fake-quantise every weight of a (nested) dict of tensors — those with
    ndim >= 2 by default; biases and norms stay full precision."""
    if predicate is None:
        predicate = lambda x: x.ndim >= 2  # noqa: E731

    def f(x):
        if isinstance(x, dict):
            return {k: f(v) for k, v in x.items()}
        return fake_quant_int8(x) if predicate(x) else x

    return f(params)


def feature_thresholds(features: torch.Tensor,
                       method: Literal["mean", "median"] = "mean"
                       ) -> torch.Tensor:
    """Per-feature threshold over samples: features (n, N) -> (N,)."""
    if method == "mean":
        return features.mean(dim=0)
    if method == "median":
        # jnp.median averages the two middle values of an even count
        return torch.quantile(features, 0.5, dim=0)
    raise ValueError(f"unknown threshold method: {method}")


def binarize(features: torch.Tensor, thresholds: torch.Tensor
             ) -> torch.Tensor:
    """1 where feature > threshold else 0 (float32)."""
    return (features > thresholds).to(torch.float32)
