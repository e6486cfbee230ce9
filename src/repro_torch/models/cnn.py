"""The paper's student CNN front end (Fig. 5), forward only.

    conv1 32 (3x3, VALID) -> ReLU -> BN -> maxpool2
    conv2 128 (3x3, SAME) -> ReLU -> BN -> maxpool2
    conv3 256 (3x3, SAME) -> ReLU
    conv4 16 (3x3, SAME)  -> ReLU            # feature-map reducer
    32x32x1 -> 30 -> 15 -> 15 -> 7 -> 7x7x256 -> 7x7x16 = 784 features

The order is the JAX package's: ReLU *before* BatchNorm (eval statistics,
eps 1e-5); maxpool floors 15 -> 7. The public functions take NHWC inputs like
the JAX package and permute inside, and the 784 features are flattened in
NHWC order (index ``(h * 7 + w) * 16 + c``), so every threshold and
template lands on the same feature in both packages.

On the card the convolutions and the head run in full float32: cuDNN's
TF32 (on by default for convolutions) is switched off around the forward,
and ``torch.backends.cuda.matmul.allow_tf32`` is held False. TF32 moves
features by about 1e-3, which flips binarised bits near a threshold.

The teacher ResNet and training mode (batch statistics) come with the
training slice of the port.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.quant import fake_quant_int8
from repro_torch.device import resolve

BN_EPS = 1e-5


class StudentConfig(NamedTuple):
    in_channels: int = 1  # greyscale per §IV-A
    filters: tuple[int, int, int, int] = (32, 128, 256, 16)
    num_classes: int = 10

    @property
    def num_features(self) -> int:
        return 7 * 7 * self.filters[3]  # 784 at the paper's sizes


class Student(nn.Module):
    """The Fig. 5 student: conv front end + dense softmax head."""

    def __init__(self, cfg: StudentConfig = StudentConfig()):
        super().__init__()
        self.cfg = cfg
        f1, f2, f3, f4 = cfg.filters
        self.conv1 = nn.Conv2d(cfg.in_channels, f1, 3)
        self.bn1 = nn.BatchNorm2d(f1, eps=BN_EPS)
        self.conv2 = nn.Conv2d(f1, f2, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(f2, eps=BN_EPS)
        self.conv3 = nn.Conv2d(f2, f3, 3, padding=1)
        self.conv4 = nn.Conv2d(f3, f4, 3, padding=1)
        self.head = nn.Linear(cfg.num_features, cfg.num_classes)

    def features(self, x: torch.Tensor, *, quantize: bool = False
                 ) -> torch.Tensor:
        """NHWC images (B, 32, 32, C) -> (B, num_features) NHWC-flat."""
        def conv(m: nn.Conv2d, h):
            w = fake_quant_int8(m.weight) if quantize else m.weight
            return F.relu(F.conv2d(h, w, m.bias, padding=m.padding))

        def bn(m: nn.BatchNorm2d, h):
            return F.batch_norm(h, m.running_mean, m.running_var, m.weight,
                                m.bias, training=False, eps=m.eps)

        h = x.permute(0, 3, 1, 2)
        h = F.max_pool2d(bn(self.bn1, conv(self.conv1, h)), 2)  # 30 -> 15
        h = F.max_pool2d(bn(self.bn2, conv(self.conv2, h)), 2)  # 15 -> 7
        h = conv(self.conv4, conv(self.conv3, h))  # 7x7xf4
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)

    def forward(self, x: torch.Tensor, *, quantize: bool = False
                ) -> torch.Tensor:
        # the dense head stays full precision, as in the JAX package
        return self.head(self.features(x, quantize=quantize))


@contextlib.contextmanager
def _fp32(device: torch.device):
    """Full-float32 convolutions and products on the card (no TF32)."""
    if device.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prev


def _as_input(params: Student, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=params.conv1.weight.device)


def init_student(generator: torch.Generator,
                 cfg: StudentConfig = StudentConfig(), *,
                 device=None) -> Student:
    """He-normal weights (std sqrt(2 / fan_in)) drawn from ``generator``
    on the CPU, zero biases, identity BN statistics; on ``device`` (the card
    unless the caller asks for the CPU), in eval mode."""
    model = Student(cfg)
    with torch.no_grad():
        for m in (model.conv1, model.conv2, model.conv3, model.conv4,
                  model.head):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_in))
            m.bias.zero_()
    return model.to(resolve(device)).eval()


def student_features(params: Student, x, *, quantize: bool = False
                     ) -> torch.Tensor:
    """Front-end features (B, 784) of NHWC images; ``quantize`` runs the
    weights through int8 fake-quant (deployment)."""
    x = _as_input(params, x)
    with torch.no_grad(), _fp32(x.device):
        return params.features(x, quantize=quantize)


def student_logits(params: Student, x, *, quantize: bool = False
                   ) -> torch.Tensor:
    """Dense-head logits (B, num_classes) of NHWC images."""
    x = _as_input(params, x)
    with torch.no_grad(), _fp32(x.device):
        return params(x, quantize=quantize)


def student_macs(cfg: StudentConfig = StudentConfig()) -> dict[str, int]:
    """Eq. 13 MAC counts per layer (+ the dense softmax head)."""
    f1, f2, f3, f4 = cfg.filters
    layers = {
        "conv1": 30 * 30 * 3 * 3 * cfg.in_channels * f1,
        "conv2": 15 * 15 * 3 * 3 * f1 * f2,
        "conv3": 7 * 7 * 3 * 3 * f2 * f3,
        "conv4": 7 * 7 * 3 * 3 * f3 * f4,
        "head": cfg.num_features * cfg.num_classes + cfg.num_classes,
    }
    layers["total"] = sum(layers.values())
    return layers
