"""The paper's distillation step (§II-A and §II-B), written from the paper
and the configuration in plain PyTorch, for the benchmark's checks.

A step of the pruned student's fine-tuning: the Eq. 1 loss
``alpha * T^2 * KL(softmax(z_t / T) || softmax(z_s / T)) + (1 - alpha) *
CE(z_s, y)`` with the student in train mode; its gradient; the pruned
weights' gradients zeroed; every gradient scaled by ``min(1, clip / (norm
+ 1e-9))`` of their global norm; AdamW as the configuration states it (the
decay added to the Adam direction, ``p - lr * (m_hat / (sqrt(v_hat) + eps)
+ wd * p)``, on tensors of two or more dimensions only); the pruned
weights zeroed again.

Pruning (Eq. 5-7): a prunable tensor (two or more dimensions) keeps the
weights whose magnitude is at least the ``sparsity`` quantile of its
magnitudes (linear interpolation), taken in float32 on the float32
weights the configuration draws.

`KDTrainer.load` takes up another trainer's state as it stands (for the
check of the step after the window, which can only follow the program
from the state that the window left).
"""
from __future__ import annotations

import torch

from bench.reference import resnet, student
from bench.reference.precision import Precision


def masks_of(weights: dict, sparsity: float) -> dict:
    out = {}
    for k, w in weights.items():
        if w.ndim >= 2:
            a = w.detach().to(torch.float32).abs().reshape(-1)
            theta = torch.quantile(a, torch.tensor(
                sparsity, dtype=torch.float32, device=a.device))
            out[k] = w.detach().abs() >= theta
    return out


def kd_loss(zs: torch.Tensor, zt: torch.Tensor, y: torch.Tensor,
            alpha: float, temperature: float) -> torch.Tensor:
    t = temperature
    log_ps = torch.log_softmax(zs / t, dim=-1)
    log_pt = torch.log_softmax(zt / t, dim=-1)
    kl = (log_pt.exp() * (log_pt - log_ps)).sum(dim=-1).mean()
    ce = -torch.log_softmax(zs, dim=-1).gather(1, y[:, None]).mean()
    return alpha * t * t * kl + (1 - alpha) * ce


class KDTrainer:
    """The student, its AdamW state and the teacher, in ``prec``.

    ``student_w`` and ``teacher_w``: the float32 weights as drawn
    (parameters and BatchNorm statistics); ``opt``: the configuration's
    trainer settings (lr, weight_decay, b1, b2, eps, clip, alpha,
    temperature, sparsity)."""

    def __init__(self, student_w: dict, teacher_w: dict, opt: dict,
                 prec: Precision, device: torch.device):
        self.prec, self.opt, self.device = prec, opt, device
        params = {k: v for k, v in student_w.items()
                  if not k.endswith(("running_mean", "running_var"))}
        self.masks = {k: m.to(device)
                      for k, m in masks_of(params, opt["sparsity"]).items()}
        self.params = {k: self._mask(k, prec.cast(v.to(device)))
                       for k, v in params.items()}
        self.params0 = dict(self.params)
        self.teacher = {k: v.to(device) for k, v in teacher_w.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.first_grad = None
        self.grad = None  # the last step's gradient as AdamW received it

    def load(self, params: dict, mu: dict, nu: dict, t: int) -> None:
        """Go on from another trainer's state, taken as it is: parameters,
        AdamW's moments and its step count."""
        def take(tree):
            return {k: self.prec.cast(tree[k].to(self.device))
                    for k in self.params}

        self.params, self.mu, self.nu = take(params), take(mu), take(nu)
        self.t = t

    def _mask(self, k: str, v: torch.Tensor) -> torch.Tensor:
        return v * self.masks[k].to(v.dtype) if k in self.masks else v

    def teacher_logits(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), self.prec.flags():
            return resnet.logits(self.teacher, x, self.prec)

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One step on images ``x`` and labels ``y``; returns the loss."""
        o, prec = self.opt, self.prec
        zt = self.teacher_logits(x)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        with torch.enable_grad(), prec.flags():
            zs = student.logits(leaves, x, prec, train=True)
            loss = kd_loss(zs, zt, y, o["alpha"], o["temperature"])
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        grads = {k: self._mask(k, g) for k, g in grads.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.clamp(o["clip"] / (norm + 1e-9), max=1.0)
        grads = {k: g * scale for k, g in grads.items()}
        if self.first_grad is None:
            self.first_grad = grads
        self.grad = grads
        self.t += 1
        b1, b2 = o["b1"], o["b2"]
        for k, g in grads.items():
            self.mu[k] = b1 * self.mu[k] + (1 - b1) * g
            self.nu[k] = b2 * self.nu[k] + (1 - b2) * g * g
            u = ((self.mu[k] / (1 - b1 ** self.t))
                 / (torch.sqrt(self.nu[k] / (1 - b2 ** self.t)) + o["eps"]))
            p = self.params[k]
            if p.ndim >= 2:
                u = u + o["weight_decay"] * p
            self.params[k] = self._mask(k, p - o["lr"] * u)
        return loss.detach()
