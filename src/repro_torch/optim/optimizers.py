"""Optimisers as plain tensor code (the JAX package's own, not
`torch.optim`): AdamW, SGD+momentum, LR schedules, global-norm clipping.

Parameters, gradients and optimiser moments are dicts of tensors keyed by
name; `update` returns new dicts and leaves its inputs alone, as the JAX
version does. Two details differ from `torch.optim.AdamW` and are kept
here: the weight decay is added to the Adam direction (``u = m_hat /
(sqrt(v_hat) + eps) + wd * p``, then ``p - lr * u``), and it applies only to
tensors with ``ndim >= 2`` (weights, not biases or norms). That rule reads
the JAX leaf's rank: a model whose JAX tree stacks tensors that the port
keeps apart (the LM's layers) passes `adamw` its own ``decay`` predicate
(`repro_torch.launch.steps.decays`).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Params  # first moment / momentum
    nu: Params | None  # second moment (None for SGD)


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params], tuple[Params, OptState]]


def _zeros_like_f32(p: Params) -> Params:
    return {k: torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            for k, x in p.items()}


def _step0(params: Params) -> torch.Tensor:
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _lr(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


def _matrix(name: str, p: torch.Tensor) -> bool:
    return p.ndim >= 2


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor], *,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          decay: Callable[[str, torch.Tensor], bool] = _matrix) -> Optimizer:
    """AdamW; ``decay(name, param)`` picks the tensors that take the weight
    decay (default: ``ndim >= 2``)."""

    def init(params):
        return OptState(_step0(params), _zeros_like_f32(params),
                        _zeros_like_f32(params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr(lr, step)
        mu = {k: b1 * m + (1 - b1) * grads[k].float()
              for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].float())
              for k, v in state.nu.items()}
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32,
                               device=stepf.device) ** stepf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32,
                               device=stepf.device) ** stepf

        def upd(k, p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and decay(k, p):  # weights, not bias/norm
                u = u + weight_decay * p.float()
            return (p.float() - lr_t * u).to(p.dtype)

        new = {k: upd(k, p.detach(), mu[k], nu[k])
               for k, p in params.items()}
        return new, OptState(step, mu, nu)

    return Optimizer(init, update)


def sgd(lr: float | Callable[[torch.Tensor], torch.Tensor], *,
        momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(_step0(params), _zeros_like_f32(params), None)

    def update(grads, state, params):
        step = state.step + 1
        lr_t = _lr(lr, step)

        def add_wd(g, p):
            g = g.float()
            if weight_decay and p.ndim >= 2:
                return g + weight_decay * p.detach().float()
            return g

        g_wd = {k: add_wd(grads[k], p) for k, p in params.items()}
        mu = {k: momentum * state.mu[k] + g for k, g in g_wd.items()}
        src = ({k: g + momentum * mu[k] for k, g in g_wd.items()}
               if nesterov else mu)
        new = {k: (p.detach().float() - lr_t * src[k]).to(p.dtype)
               for k, p in params.items()}
        return new, OptState(step, mu, None)

    return Optimizer(init, update)


# --- schedules ---

def cosine_schedule(base_lr: float, total_steps: int, warmup: int = 0,
                    final_frac: float = 0.0
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0, 1)
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return f


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    """``g * min(1, max_norm / (norm + 1e-9))`` for every gradient, in
    JAX's type promotion: a bf16 gradient times the f32 scale is an f32
    product, not one rounded back to bf16."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            for k, g in grads.items()}, norm
