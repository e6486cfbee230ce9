"""Seeded greyscale frames and weights, made on the run's device.

Frames (32x32x1, NHWC float32): each class is an oriented sinusoidal
texture with its own frequency band and orientation; a frame of class c
takes a random phase, a jitter of its frequency and orientation, a random
contrast and offset, and Gaussian pixel noise. The phase spreads a class
over several clusters, so k-means templates (k > 1) have structure to find.
Every size is fixed by the traffic's parameters, so every seed makes the
same work.

Weights are drawn in a few calls from the run's generator, in float32, the
type the configurations state: He-normal convolution and dense weights
(std sqrt(2 / fan_in)).
"""
from __future__ import annotations

import math

import torch


def frames(gen: torch.Generator, labels: torch.Tensor, noise: float
           ) -> torch.Tensor:
    """(n, 32, 32, 1) frames of classes ``labels`` (n,)."""
    n, dev = labels.shape[0], labels.device
    u = torch.rand((n, 5), generator=gen, device=dev)
    c = labels.to(torch.float32)
    freq = (1.5 + 0.35 * c) * (0.95 + 0.1 * u[:, 0])
    theta = math.pi / 10 * c + 0.2 * (u[:, 1] - 0.5)
    phase = 2 * math.pi * u[:, 2]
    contrast = 0.5 + 0.5 * u[:, 3]
    offset = u[:, 4] - 0.5
    grid = torch.linspace(-1.0, 1.0, 32, device=dev)
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    proj = (xx[None] * torch.cos(theta)[:, None, None]
            + yy[None] * torch.sin(theta)[:, None, None])
    img = (contrast[:, None, None]
           * torch.sin(2 * math.pi * freq[:, None, None] * proj
                       + phase[:, None, None]) + offset[:, None, None])
    img = img + noise * torch.randn((n, 32, 32), generator=gen, device=dev)
    return img[..., None].contiguous()


def labels(gen: torch.Generator, n: int, num_classes: int,
           device: torch.device) -> torch.Tensor:
    return torch.randint(0, num_classes, (n,), generator=gen, device=device)


def he_normal(gen: torch.Generator, shapes: dict, device: torch.device
              ) -> dict:
    """He-normal tensors of ``shapes`` (name -> shape), from one draw."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        fan_in = math.prod(shape[1:])
        out[name] = flat[at:at + size].view(shape) * math.sqrt(2.0 / fan_in)
        at += size
    return out


def student_shapes(cfg: dict) -> dict:
    f1, f2, f3, f4 = cfg["filters"]
    cin, nf = cfg["in_channels"], cfg["num_features"]
    return {"conv1.weight": (f1, cin, 3, 3), "conv2.weight": (f2, f1, 3, 3),
            "conv3.weight": (f3, f2, 3, 3), "conv4.weight": (f4, f3, 3, 3),
            "head.weight": (cfg["num_classes"], nf)}


def student_weights(gen: torch.Generator, cfg: dict, device: torch.device,
                    *, deployed: bool) -> dict:
    """The student's parameters and BatchNorm statistics. ``deployed``:
    small random biases, BatchNorm scales, shifts and running statistics,
    as a trained front end carries; else the training start (zero biases,
    unit scales, zero shifts, running mean 0 and variance 1)."""
    w = he_normal(gen, student_shapes(cfg), device)
    f1, f2, f3, f4 = cfg["filters"]
    biases = {"conv1.bias": f1, "conv2.bias": f2, "conv3.bias": f3,
              "conv4.bias": f4, "head.bias": cfg["num_classes"]}
    bn = {"bn1": f1, "bn2": f2}
    if deployed:
        z = torch.randn(sum(biases.values()) + 3 * (f1 + f2),
                        generator=gen, device=device)
        r = torch.rand(f1 + f2, generator=gen, device=device)
        at = 0
        for name, size in biases.items():
            w[name] = 0.05 * z[at:at + size]
            at += size
        ra = 0
        for name, size in bn.items():
            w[f"{name}.weight"] = 1.0 + 0.2 * z[at:at + size]
            w[f"{name}.bias"] = 0.1 * z[at + size:at + 2 * size]
            w[f"{name}.running_mean"] = 0.1 * z[at + 2 * size:at + 3 * size]
            w[f"{name}.running_var"] = 0.5 + 1.5 * r[ra:ra + size]
            at, ra = at + 3 * size, ra + size
    else:
        for name, size in biases.items():
            w[name] = torch.zeros(size, device=device)
        for name, size in bn.items():
            w[f"{name}.weight"] = torch.ones(size, device=device)
            w[f"{name}.bias"] = torch.zeros(size, device=device)
            w[f"{name}.running_mean"] = torch.zeros(size, device=device)
            w[f"{name}.running_var"] = torch.ones(size, device=device)
    return {k: v.contiguous() for k, v in w.items()}


def teacher_weights(gen: torch.Generator, cfg: dict, device: torch.device
                    ) -> dict:
    """The ResNet teacher's parameters and BatchNorm statistics at the
    training start (He-normal weights, zero biases, unit BatchNorm)."""
    width, blocks = cfg["teacher_width"], cfg["teacher_blocks_per_stage"]
    shapes = {"stem.weight": (width, cfg["in_channels"], 3, 3)}
    chans = {"stem": width, "bn_stem": width}
    cin = width
    for s in range(3):
        cout = width * 2 ** s
        for j in range(blocks):
            name = f"s{s}b{j}"
            shapes[f"{name}.conv1.weight"] = (cout, cin, 3, 3)
            shapes[f"{name}.conv2.weight"] = (cout, cout, 3, 3)
            chans.update({f"{name}.conv1": cout, f"{name}.conv2": cout,
                          f"{name}.bn1": cout, f"{name}.bn2": cout})
            if cin != cout:
                shapes[f"{name}.proj.weight"] = (cout, cin, 1, 1)
                chans[f"{name}.proj"] = cout
            cin = cout
    shapes["head.weight"] = (cfg["num_classes"], cin)
    chans["head"] = cfg["num_classes"]
    w = he_normal(gen, shapes, device)
    for name, size in chans.items():
        if name.split(".")[-1].startswith("bn"):
            w[f"{name}.weight"] = torch.ones(size, device=device)
            w[f"{name}.bias"] = torch.zeros(size, device=device)
            w[f"{name}.running_mean"] = torch.zeros(size, device=device)
            w[f"{name}.running_var"] = torch.ones(size, device=device)
        else:
            w[f"{name}.bias"] = torch.zeros(size, device=device)
    return {k: v.contiguous() for k, v in w.items()}
