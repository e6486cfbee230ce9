"""Quantisation schemes (paper §II-C).

  1. 8-bit symmetric per-tensor fake-quant for model weights (QAT /
     deployment), with a straight-through gradient: the backward passes
     the incoming gradient on unchanged, as the JAX package's `custom_vjp`
     does, so QAT trains the full-precision weights.
  2. Binary (1-bit) feature-map quantisation for ACAM deployment against a
     *mean-based* per-feature threshold (Fig. 1).

`torch.round`, like `jnp.round`, rounds half to even, so the int8 grid is
the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Literal

import torch


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale).

    ``scale`` is the IEEE quotient ``amax / 127`` on every device: the
    divisor is a tensor on ``w``'s device, because CUDA divides by a Python
    scalar as a multiplication by its reciprocal, which rounds differently
    for some ``amax`` and moves weights across a rounding boundary.
    (The JAX package's eager call divides too; under `jit` XLA rewrites the
    division into that reciprocal product.)"""
    amax = torch.clamp(w.abs().max(), min=1e-8)
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        return dequantize_int8(*quantize_int8(w))

    @staticmethod
    def backward(ctx, g):
        return g  # straight-through


def fake_quant_int8(w: torch.Tensor) -> torch.Tensor:
    """Round weights onto the int8 grid; the gradient is straight-through
    (the identity), not the zero gradient of `round`."""
    return _FakeQuantSTE.apply(w)


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
