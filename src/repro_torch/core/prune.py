"""Magnitude pruning with polynomial-decay schedule (paper §II-B, Eq. 5-7).

    s(t) = s_f + (s_i - s_f) * (1 - t/n_t)^3          (Eq. 5)
    r(w_ij) = |w_ij|                                   (Eq. 6)
    theta_t = Q(|W|, s(t))                             (Eq. 7)

Weights below the s(t)-quantile of |W| are zeroed; masks are persistent so
pruned connections stay pruned across fine-tuning steps (iterative
prune + fine-tune).

Parameters are dicts of tensors keyed by name (``dict(model.
named_parameters())``); a mask dict has the same keys, all-True for the
tensors that are not prunable. Everything computes in float32 as the JAX
package does: Eq. 5 at ``t = n_t`` gives ``float32(0.8)``, which is
0.800000011920929, not the literal 0.8.
"""
from __future__ import annotations

from typing import Callable

import torch

Params = dict[str, torch.Tensor]


def polynomial_sparsity(t, n_t: int, s_i: float = 0.50, s_f: float = 0.80
                        ) -> torch.Tensor:
    """Eq. 5 as a float32 scalar. Clamps t to [0, n_t]."""
    frac = torch.clamp(torch.as_tensor(t, dtype=torch.float32) / n_t,
                       0.0, 1.0)
    return s_f + (s_i - s_f) * (1.0 - frac) ** 3


def _default_prunable(name: str, leaf: torch.Tensor) -> bool:
    return leaf.ndim >= 2  # weights only; biases/norms untouched


def magnitude_threshold(w: torch.Tensor, sparsity) -> torch.Tensor:
    """Eq. 7: the sparsity-quantile of |w| (per-tensor), linear
    interpolation like `jnp.quantile`. `torch.quantile` takes at most 2^24
    elements."""
    a = w.detach().abs().reshape(-1)
    return torch.quantile(a, torch.as_tensor(sparsity, dtype=a.dtype,
                                             device=a.device))


def prune_tree(params: Params, sparsity, *,
               prunable: Callable[[str, torch.Tensor], bool]
               = _default_prunable,
               global_ranking: bool = False) -> tuple[Params, Params]:
    """Prune `params` to `sparsity`; returns (pruned_params, masks), new
    tensors (the inputs are not modified).

    global_ranking=True ranks all prunable weights together (one global
    threshold, Eq. 7 over the concatenated |W|); False applies Eq. 7
    per-tensor. A weight is kept where ``|w| >= theta``.
    """
    sparsity = torch.as_tensor(sparsity, dtype=torch.float32)
    if global_ranking:
        flat = [leaf.detach().abs().reshape(-1)
                for name, leaf in params.items() if prunable(name, leaf)]
        theta = magnitude_threshold(torch.cat(flat), sparsity) if flat \
            else 0.0
    masks = {}
    for name, leaf in params.items():
        if not prunable(name, leaf):
            masks[name] = torch.ones_like(leaf, dtype=torch.bool)
            continue
        th = theta if global_ranking else magnitude_threshold(leaf, sparsity)
        masks[name] = leaf.detach().abs() >= th
    return apply_masks(params, masks), masks


def apply_masks(params: Params, masks: Params) -> Params:
    """Re-apply persistent masks (after a fine-tuning gradient step)."""
    return {k: w * masks[k].to(w.dtype) for k, w in params.items()}


def mask_gradients(grads: Params, masks: Params) -> Params:
    """Zero gradients of pruned weights so optimiser state stays clean."""
    return {k: g * masks[k].to(g.dtype) for k, g in grads.items()}


def sparsity_of(params: Params, *, prunable=_default_prunable) -> float:
    """Measured sparsity over prunable leaves."""
    total, zeros = 0, 0
    for name, leaf in params.items():
        if prunable(name, leaf):
            total += leaf.numel()
            zeros += int((leaf == 0).sum())
    return zeros / max(total, 1)


# ---------------------------------------------------------------------------
# Sparse storage format (paper: "remaining non-zero weights are then stored
# using a sparse matrix format")
# ---------------------------------------------------------------------------

def to_sparse(w: torch.Tensor) -> dict[str, torch.Tensor]:
    """COO-style sparse encoding of a pruned tensor."""
    flat = w.detach().reshape(-1)
    idx = torch.nonzero(flat)[:, 0]
    return {
        "shape": torch.tensor(w.shape, dtype=torch.int32),
        "indices": idx.to(torch.int32),
        "values": flat[idx],
    }


def from_sparse(s: dict[str, torch.Tensor]) -> torch.Tensor:
    shape = tuple(int(d) for d in s["shape"])
    out = torch.zeros(int(torch.prod(s["shape"])), dtype=s["values"].dtype,
                      device=s["values"].device)
    out[s["indices"].long()] = s["values"]
    return out.reshape(shape)


def sparse_nbytes(s: dict[str, torch.Tensor]) -> int:
    return int(s["indices"].numel() * 4
               + s["values"].numel() * s["values"].element_size())
