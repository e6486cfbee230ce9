"""The teacher's training step (the trainer's ``train_teacher``), written
from the configuration in plain PyTorch, for the benchmark's checks.

A step: the ResNet-20 of `resnet` in train mode (each BatchNorm on its
batch's statistics, `student.batchnorm`); the cross entropy of its logits
against the labels; its gradient; every gradient scaled by ``min(1, clip /
(norm + 1e-9))`` of their global norm; AdamW as `train.KDTrainer` takes it
(the decay added to the Adam direction, on tensors of two or more
dimensions only). Nothing is pruned.

`TeacherTrainer` keeps `train.KDTrainer`'s interface (``params``,
``params0``, ``mu``, ``nu``, ``t``, ``first_grad``, ``grad``, ``load``,
``step(x, y)``), so that the checks of the KD step serve this one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import resnet
from bench.reference.precision import Precision
from bench.reference.student import batchnorm


def logits_train(p: dict, x: torch.Tensor, prec: Precision, *,
                 width: int = 16, blocks: int = 3) -> torch.Tensor:
    """(B, 32, 32, C) images -> (B, classes) logits, train mode."""
    conv = resnet.conv_same
    h = prec.cast(x).permute(0, 3, 1, 2)
    h = F.relu(batchnorm(conv(h, p["stem.weight"], p["stem.bias"], 1, prec),
                         p, "bn_stem", True))
    cin = width
    for s in range(3):
        cout = width * 2 ** s
        for j in range(blocks):
            name, stride = f"s{s}b{j}", (2 if s > 0 and j == 0 else 1)
            y = conv(h, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"],
                     stride, prec)
            y = F.relu(batchnorm(y, p, f"{name}.bn1", True))
            y = conv(y, p[f"{name}.conv2.weight"], p[f"{name}.conv2.bias"], 1,
                     prec)
            y = batchnorm(y, p, f"{name}.bn2", True)
            sc = h if cin == cout else conv(
                h, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"], stride,
                prec)
            h = F.relu(y + sc)
            cin = cout
    pooled = h.mean(dim=(2, 3))
    return (prec.operand(pooled) @ prec.operand(p["head.weight"]).T
            + p["head.bias"])


class TeacherTrainer:
    """The teacher and its AdamW state, in ``prec``. ``teacher_w``: the
    float32 weights as drawn (parameters and BatchNorm statistics);
    ``opt``: lr, weight_decay, b1, b2, eps, clip."""

    def __init__(self, teacher_w: dict, opt: dict, prec: Precision,
                 device: torch.device):
        self.prec, self.opt, self.device = prec, opt, device
        self.params = {k: prec.cast(v.to(device))
                       for k, v in teacher_w.items()
                       if not k.endswith(("running_mean", "running_var"))}
        self.params0 = dict(self.params)
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.t = 0
        self.first_grad = None
        self.grad = None  # the last step's gradient as AdamW received it

    def load(self, params: dict, mu: dict, nu: dict, t: int) -> None:
        def take(tree):
            return {k: self.prec.cast(tree[k].to(self.device))
                    for k in self.params}

        self.params, self.mu, self.nu = take(params), take(mu), take(nu)
        self.t = t

    def step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        o, prec = self.opt, self.prec
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        with torch.enable_grad(), prec.flags():
            z = logits_train(leaves, x, prec)
            loss = -torch.log_softmax(z, dim=-1).gather(1, y[:, None]).mean()
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
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
            self.params[k] = p - o["lr"] * u
        return loss.detach()
