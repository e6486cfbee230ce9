"""Plain PyTorch oracle for the acam_similarity kernels (paper Eq. 9-11).

    D = sum_i relu(Q_i - U_i)^2 + relu(L_i - Q_i)^2       (Eq. 9)
    H = (1/N) sum_i 1(L_i <= Q_i <= U_i)                  (Eq. 10)
    S = H / (1 + alpha * D)                               (Eq. 11)

The arithmetic is spelled out in the order XLA compiles the JAX package's
kernels and jitted references on the CPU: the hit count as an exact
integer, then ``h = count * inv_n`` with ``inv_n = float32(1) /
float32(N)`` (XLA turns the division by the constant N into that
multiplication, so ``count / N`` and ``mean`` can differ from it by one
ulp), then the denominator ``1 + alpha * D`` as ONE fused multiply-add
(XLA contracts the product and the sum inside a fusion: one rounding, not
two), then ``h / den`` in f32. Every similarity computation of the port,
plain versions and CUDA kernels alike, goes through these steps. (JAX run
op by op, outside ``jit``, rounds the product on its own; that differs in
about one cell in a hundred at ``alpha = 0.37`` and is not what the
kernels compute.)
"""
from __future__ import annotations

import numpy as np
import torch

#: (B, M, N) cells materialised at once by the plain versions
CELLS_PER_PASS = 1 << 24


def inv_n(n: int) -> float:
    """float32(1) / float32(N), the f32 reciprocal Eq. 10 multiplies by."""
    return float(np.float32(1) / np.float32(n))


def fma_one(alpha: float, dist: torch.Tensor) -> torch.Tensor:
    """f32 ``alpha * dist + 1`` rounded once, as a fused multiply-add.

    The product of two f32 values is exact in float64; the float64 sum is
    then rounded to odd (TwoSum gives its exact error, and an inexact sum
    with an even last bit steps one ulp toward the error), after which the
    rounding to f32 is the correctly rounded fused result."""
    p = torch.tensor(float(np.float32(alpha)), dtype=torch.float64,
                     device=dist.device) * dist.to(torch.float64)
    s = p + 1.0
    bv = s - p
    err = (p - (s - bv)) + (1.0 - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.tensor(float("inf"), dtype=s.dtype,
                                               device=s.device),
                         torch.tensor(float("-inf"), dtype=s.dtype,
                                      device=s.device))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def eq11(hits: torch.Tensor, dist: torch.Tensor, n: int,
         alpha: float) -> torch.Tensor:
    """S = (hits * inv_n) / fma(alpha, D, 1) in f32."""
    h = hits.to(torch.float32) * torch.tensor(
        inv_n(n), dtype=torch.float32, device=hits.device)
    return h / fma_one(alpha, dist.to(torch.float32))


def hits_and_distance(q: torch.Tensor, lower: torch.Tensor,
                      upper: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 9 D and the Eq. 10 hit count of queries (B, N) against windows
    (M, N): two (B, M) tensors, the count exact in int64. The (B, M, N)
    intermediate is built a slice of template rows at a time."""
    b, n = q.shape
    m = lower.shape[0]
    q = q.to(torch.float32)[:, None, :]
    step = max(1, CELLS_PER_PASS // max(b * n, 1))
    hits, dist = [], []
    for r in range(0, m, step):
        lo = lower[r:r + step].to(torch.float32)[None]
        hi = upper[r:r + step].to(torch.float32)[None]
        above = torch.clamp(q - hi, min=0.0)
        below = torch.clamp(lo - q, min=0.0)
        dist.append((above * above + below * below).sum(dim=-1))
        hits.append(((q >= lo) & (q <= hi)).sum(dim=-1))
    if not hits:
        z = torch.zeros((b, 0), device=q.device)
        return z.to(torch.int64), z
    return torch.cat(hits, dim=1), torch.cat(dist, dim=1)


def acam_similarity_ref(queries: torch.Tensor, lower: torch.Tensor,
                        upper: torch.Tensor, *,
                        alpha: float = 1.0) -> torch.Tensor:
    """(B, M) Eq. 11 scores of queries (B, N) against windows (M, N)."""
    hits, dist = hits_and_distance(queries, lower, upper)
    return eq11(hits, dist, queries.shape[-1], alpha)
