"""The paper's Fig. 5 student, written from the paper and the
configuration in plain PyTorch, for the benchmark's checks.

    conv 32 (3x3, VALID) -> ReLU -> BatchNorm -> max-pool 2
    conv 128 (3x3, SAME) -> ReLU -> BatchNorm -> max-pool 2
    conv 256 (3x3, SAME) -> ReLU
    conv 16 (3x3, SAME)  -> ReLU
    32x32x1 -> 30 -> 15 -> 15 -> 7 -> 7x7x16 = 784 features (flattened
    height, width, channel), then a dense head to the class logits.

BatchNorm: ``(h - mean) / sqrt(var + 1e-5) * weight + bias``; in train mode
``mean`` and ``var`` are the batch's (the biased variance), in eval mode the
running statistics. Weights are a dict keyed as the configuration names
them (``conv1.weight``, ``bn1.running_var``, ``head.bias`` ...); images are
NHWC. Every product and convolution runs in ``prec``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.precision import Precision

BN_EPS = 1e-5


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, padding: int,
         prec: Precision) -> torch.Tensor:
    return F.conv2d(prec.operand(x), prec.operand(w), b, padding=padding)


def batchnorm(h: torch.Tensor, p: dict, name: str, train: bool
              ) -> torch.Tensor:
    if train:
        mean = h.mean(dim=(0, 2, 3))
        var = ((h - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    scale = p[f"{name}.weight"] / torch.sqrt(var + BN_EPS)
    return ((h - mean[:, None, None]) * scale[:, None, None]
            + p[f"{name}.bias"][:, None, None])


def features(p: dict, x: torch.Tensor, prec: Precision, *,
             train: bool = False) -> torch.Tensor:
    """(B, 32, 32, 1) images -> (B, 784) features, in ``prec`` (``p`` and
    ``x`` are cast to it)."""
    p = {k: prec.cast(v) for k, v in p.items()}
    h = prec.cast(x).permute(0, 3, 1, 2)
    h = F.relu(conv(h, p["conv1.weight"], p["conv1.bias"], 0, prec))
    h = F.max_pool2d(batchnorm(h, p, "bn1", train), 2)
    h = F.relu(conv(h, p["conv2.weight"], p["conv2.bias"], 1, prec))
    h = F.max_pool2d(batchnorm(h, p, "bn2", train), 2)
    h = F.relu(conv(h, p["conv3.weight"], p["conv3.bias"], 1, prec))
    h = F.relu(conv(h, p["conv4.weight"], p["conv4.bias"], 1, prec))
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def logits(p: dict, x: torch.Tensor, prec: Precision, *,
           train: bool = False) -> torch.Tensor:
    f = features(p, x, prec, train=train)
    w, b = prec.cast(p["head.weight"]), prec.cast(p["head.bias"])
    return prec.operand(f) @ prec.operand(w).T + b


def features_in_blocks(p: dict, x: torch.Tensor, prec: Precision,
                       rows: int = 1024) -> torch.Tensor:
    """Eval-mode `features` of ``x`` (on any device, moved to ``p``'s)
    ``rows`` images at a time."""
    dev = next(iter(p.values())).device
    with torch.no_grad(), prec.flags():
        return torch.cat([features(p, x[i:i + rows].to(dev), prec)
                          for i in range(0, x.shape[0], rows)])
