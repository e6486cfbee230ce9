"""The CIFAR ResNet-20 teacher (He et al., arXiv:1512.03385 §4.2: n = 3,
filters 16 / 32 / 64), written from the paper and the configuration in
plain PyTorch, eval mode, for the benchmark's checks.

A 3x3 stem, then three stages of three basic blocks (conv 3x3 -> BN ->
ReLU -> conv 3x3 -> BN, plus the shortcut, then ReLU); the first block of
stages 2 and 3 strides 2 and its shortcut is a strided 1x1 convolution.
Global average pool, dense head. Convolutions pad "SAME" as the
configuration states it: the output is ceil(in / stride) and an odd total
pad puts the extra row and column after. Weights are keyed as the
configuration names them (``stem.weight``, ``s1b0.proj.weight`` ...).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.precision import Precision
from bench.reference.student import batchnorm


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              stride: int, prec: Precision) -> torch.Tensor:
    pads = []
    for size, k in zip(reversed(x.shape[2:]), reversed(w.shape[2:])):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(prec.operand(F.pad(x, pads)), prec.operand(w), b,
                    stride=stride)


def logits(p: dict, x: torch.Tensor, prec: Precision, *, width: int = 16,
           blocks: int = 3) -> torch.Tensor:
    """(B, 32, 32, C) images -> (B, classes) logits, eval mode."""
    p = {k: prec.cast(v) for k, v in p.items()}
    h = prec.cast(x).permute(0, 3, 1, 2)
    h = F.relu(batchnorm(conv_same(h, p["stem.weight"], p["stem.bias"], 1,
                                   prec), p, "bn_stem", False))
    cin = width
    for s in range(3):
        cout = width * 2 ** s
        for j in range(blocks):
            name, stride = f"s{s}b{j}", (2 if s > 0 and j == 0 else 1)
            y = conv_same(h, p[f"{name}.conv1.weight"],
                          p[f"{name}.conv1.bias"], stride, prec)
            y = F.relu(batchnorm(y, p, f"{name}.bn1", False))
            y = conv_same(y, p[f"{name}.conv2.weight"],
                          p[f"{name}.conv2.bias"], 1, prec)
            y = batchnorm(y, p, f"{name}.bn2", False)
            if cin != cout:
                sc = conv_same(h, p[f"{name}.proj.weight"],
                               p[f"{name}.proj.bias"], stride, prec)
            else:
                sc = h
            h = F.relu(y + sc)
            cin = cout
    pooled = h.mean(dim=(2, 3))
    return (prec.operand(pooled) @ prec.operand(p["head.weight"]).T
            + p["head.bias"])
