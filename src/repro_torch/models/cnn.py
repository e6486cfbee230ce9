"""CNN front ends: the paper's student (Fig. 5) and the ResNet teacher.

Student (Fig. 5):
    conv1 32 (3x3, VALID) -> ReLU -> BN -> maxpool2
    conv2 128 (3x3, SAME) -> ReLU -> BN -> maxpool2
    conv3 256 (3x3, SAME) -> ReLU
    conv4 16 (3x3, SAME)  -> ReLU            # feature-map reducer
    32x32x1 -> 30 -> 15 -> 15 -> 7 -> 7x7x256 -> 7x7x16 = 784 features

Teacher: CIFAR-style ResNet — a 3x3 stem, 3 stages from `width` channels
(doubling, stride 2 at the first block of stages 2 and 3), basic blocks
(conv -> BN -> ReLU -> conv -> BN, identity or 1x1 projection shortcut,
ReLU), global average pool, dense head (paper §IV-B).

The order is the JAX package's: the student applies ReLU *before*
BatchNorm; maxpool floors 15 -> 7. The public functions take NHWC inputs
like the JAX package and permute inside, and the student's 784 features
are flattened in NHWC order (index ``(h * 7 + w) * 16 + c``), so every
threshold and template lands on the same feature in both packages.

BatchNorm follows `repro/models/cnn.py` exactly, in both modes:
``(x - mu) * rsqrt(var + 1e-5) * scale + bias``. In train mode mu and var
are the batch mean and the **biased** batch variance, and the running
statistics become ``0.9 * old + 0.1 * batch`` (biased variance too), written
into the module's buffers by hand: ``nn.BatchNorm2d``'s own train mode
would normalise the same way but fold in the unbiased variance, off by
n / (n - 1). XLA's ``"SAME"`` padding is asymmetric where the total is
odd (the stride-2 3x3 conv on an even input pads 0 before and 1 after), so
the teacher pads explicitly instead of ``Conv2d(padding=1)``.

On the card every convolution and product runs in full float32: cuDNN's
TF32 (on by default for convolutions) is switched off by `fp32`, around the
forward here and around the whole training step (backward included) in the
trainer. TF32 moves features by about 1e-3, which flips binarised bits near
a threshold and moves gradients by as much.
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
from repro_torch.kernels.student_epilogue import student_epilogue as epi

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def batchnorm(m: nn.BatchNorm2d, h: torch.Tensor, *, train: bool
              ) -> torch.Tensor:
    """The JAX package's BatchNorm on NCHW ``h``. ``train``: batch mean and
    biased variance, and the running statistics updated in place."""
    if train:
        mu = h.mean(dim=(0, 2, 3))
        var = h.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            m.running_mean.copy_(BN_MOMENTUM * m.running_mean
                                 + (1 - BN_MOMENTUM) * mu)
            m.running_var.copy_(BN_MOMENTUM * m.running_var
                                + (1 - BN_MOMENTUM) * var)
    else:
        mu, var = m.running_mean, m.running_var
    inv = torch.rsqrt(var + m.eps)
    return ((h - mu[:, None, None]) * inv[:, None, None]
            * m.weight[:, None, None] + m.bias[:, None, None])


def conv_same(m: nn.Conv2d, h: torch.Tensor) -> torch.Tensor:
    """``m`` (built with ``padding=0``) with XLA's "SAME" padding: the
    output is ceil(in / stride), and an odd total pad puts the extra row and
    column after."""
    pads = []
    for size, k, s in zip(reversed(h.shape[2:]), reversed(m.kernel_size),
                          reversed(m.stride)):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(h, pads), m.weight, m.bias, stride=m.stride)


def _he_init(generator: torch.Generator, modules) -> None:
    """He-normal weights (std sqrt(2 / fan_in)) drawn from ``generator`` on
    the CPU in the given order, zero biases."""
    with torch.no_grad():
        for m in modules:
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_in))
            m.bias.zero_()


@contextlib.contextmanager
def fp32(device: torch.device):
    """Full-float32 convolutions and products on the card (no TF32), for
    everything run inside: a forward, or a forward and its backward. cuDNN
    runs only deterministic algorithms, chosen by its heuristics (no
    benchmarking), so one seed trains the same weights every time."""
    if device.type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                         deterministic=True, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = prev


def _as_input(params: nn.Module, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32,
                           device=next(params.parameters()).device)


def _run(params: nn.Module, x, train: bool, fn) -> torch.Tensor:
    """``fn(x)`` on the model's device in full float32: with gradients in
    train mode, without in eval mode."""
    x = _as_input(params, x)
    with torch.set_grad_enabled(train and torch.is_grad_enabled()), \
            fp32(x.device):
        return fn(x)


def count_params(params: nn.Module) -> int:
    """Parameters plus BatchNorm running statistics, as the JAX package
    counts its pytree leaves."""
    return (sum(p.numel() for p in params.parameters())
            + sum(b.numel() for name, b in params.named_buffers()
                  if name.endswith(("running_mean", "running_var"))))


# ---------------------------------------------------------------------------
# Student model (Fig. 5)
# ---------------------------------------------------------------------------

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

    def features(self, x: torch.Tensor, *, quantize: bool = False,
                 train: bool = False) -> torch.Tensor:
        """NHWC images (B, 32, 32, C) -> (B, num_features) NHWC-flat.
        ``train``: BatchNorm on batch statistics, running ones updated.
        On the card in eval mode with autograd off, each convolution's tail
        is one fused launch (`kernels.student_epilogue`), bit for bit the
        chain below."""
        def weight(m: nn.Conv2d):
            return fake_quant_int8(m.weight) if quantize else m.weight

        def conv(m: nn.Conv2d, h):
            return F.relu(F.conv2d(h, weight(m), m.bias, padding=m.padding))

        h = x.permute(0, 3, 1, 2)
        if h.is_cuda and not train and not torch.is_grad_enabled():
            for m, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                          (self.conv3, None)):
                h = epi.conv_epilogue(h, weight(m), m.bias, m.padding, bn)
            return epi.conv_epilogue(h, weight(self.conv4), self.conv4.bias,
                                     self.conv4.padding, flatten=True)
        h = F.max_pool2d(batchnorm(self.bn1, conv(self.conv1, h),
                                   train=train), 2)  # 30 -> 15
        h = F.max_pool2d(batchnorm(self.bn2, conv(self.conv2, h),
                                   train=train), 2)  # 15 -> 7
        h = conv(self.conv4, conv(self.conv3, h))  # 7x7xf4
        return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)

    def forward(self, x: torch.Tensor, *, quantize: bool = False,
                train: bool = False) -> torch.Tensor:
        # the dense head stays full precision, as in the JAX package
        return self.head(self.features(x, quantize=quantize, train=train))


def init_student(generator: torch.Generator,
                 cfg: StudentConfig = StudentConfig(), *,
                 device=None) -> Student:
    """He-normal weights (std sqrt(2 / fan_in)) drawn from ``generator``
    on the CPU, zero biases, identity BN statistics; on ``device`` (the card
    unless the caller asks for the CPU), in eval mode."""
    model = Student(cfg)
    _he_init(generator, (model.conv1, model.conv2, model.conv3, model.conv4,
                         model.head))
    return model.to(resolve(device)).eval()


def student_features(params: Student, x, *, quantize: bool = False,
                     train: bool = False) -> torch.Tensor:
    """Front-end features (B, 784) of NHWC images; ``quantize`` runs the
    weights through int8 fake-quant (QAT / deployment). ``train`` runs with
    gradients on batch statistics and updates the running ones."""
    return _run(params, x, train,
                lambda x: params.features(x, quantize=quantize, train=train))


def student_logits(params: Student, x, *, quantize: bool = False,
                   train: bool = False) -> torch.Tensor:
    """Dense-head logits (B, num_classes) of NHWC images (``train`` as in
    `student_features`)."""
    return _run(params, x, train,
                lambda x: params(x, quantize=quantize, train=train))


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


# ---------------------------------------------------------------------------
# Teacher model (CIFAR-style ResNet, §IV-B)
# ---------------------------------------------------------------------------

class TeacherConfig(NamedTuple):
    in_channels: int = 3
    width: int = 16  # stage-1 channels; stages double
    blocks_per_stage: int = 3
    num_classes: int = 10


class Block(nn.Module):
    """Basic block: conv1 (stride) -> BN -> ReLU -> conv2 -> BN, plus the
    shortcut (a 1x1 ``proj`` where the width changes), then ReLU."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride)
        self.bn1 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.conv2 = nn.Conv2d(cout, cout, 3)
        self.bn2 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.proj = nn.Conv2d(cin, cout, 1, stride=stride) \
            if cin != cout else None

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        h = F.relu(batchnorm(self.bn1, conv_same(self.conv1, x), train=train))
        h = batchnorm(self.bn2, conv_same(self.conv2, h), train=train)
        if self.proj is not None:
            sc = conv_same(self.proj, x)
        elif self.stride != 1:
            sc = x[:, :, ::self.stride, ::self.stride]
        else:
            sc = x
        return F.relu(h + sc)


class Teacher(nn.Module):
    """The ResNet teacher; blocks are named ``s{stage}b{block}`` as in the
    JAX package's params."""

    def __init__(self, cfg: TeacherConfig = TeacherConfig()):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.Conv2d(cfg.in_channels, cfg.width, 3)
        self.bn_stem = nn.BatchNorm2d(cfg.width, eps=BN_EPS)
        cin = cfg.width
        for s in range(3):
            cout = cfg.width * (2**s)
            for b in range(cfg.blocks_per_stage):
                stride = 2 if (s > 0 and b == 0) else 1
                setattr(self, f"s{s}b{b}", Block(cin, cout, stride))
                cin = cout
        self.head = nn.Linear(cin, cfg.num_classes)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"s{s}b{b}") for s in range(3)
                for b in range(self.cfg.blocks_per_stage)]

    def forward(self, x: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        """NHWC images -> logits (B, num_classes)."""
        h = x.permute(0, 3, 1, 2)
        h = F.relu(batchnorm(self.bn_stem, conv_same(self.stem, h),
                             train=train))
        for block in self.blocks():
            h = block(h, train=train)
        return self.head(h.mean(dim=(2, 3)))  # global average pool


def init_teacher(generator: torch.Generator,
                 cfg: TeacherConfig = TeacherConfig(), *,
                 device=None) -> Teacher:
    """He-normal weights drawn from ``generator`` on the CPU (stem, then
    each block's conv1, conv2, proj, then the head), zero biases, identity
    BN statistics; on ``device`` (the card unless the caller asks for the
    CPU), in eval mode."""
    model = Teacher(cfg)
    convs = [model.stem]
    for block in model.blocks():
        convs += [m for m in (block.conv1, block.conv2, block.proj)
                  if m is not None]
    _he_init(generator, convs + [model.head])
    return model.to(resolve(device)).eval()


def teacher_logits(params: Teacher, x, *, train: bool = False
                   ) -> torch.Tensor:
    """Logits (B, num_classes) of NHWC images. ``train`` runs with
    gradients on batch statistics and updates the running ones."""
    return _run(params, x, train, lambda x: params(x, train=train))


def teacher_macs(cfg: TeacherConfig = TeacherConfig()) -> int:
    """Analytic MAC count for the teacher at 32x32 input."""
    total = 32 * 32 * 9 * cfg.in_channels * cfg.width
    hw, cin = 32, cfg.width
    for s in range(3):
        cout = cfg.width * (2**s)
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (s > 0 and b == 0) else 1
            hw_out = hw // stride
            total += hw_out * hw_out * 9 * cin * cout  # conv1
            total += hw_out * hw_out * 9 * cout * cout  # conv2
            if cin != cout:
                total += hw_out * hw_out * cin * cout  # proj
            hw, cin = hw_out, cout
    total += cin * cfg.num_classes
    return total
