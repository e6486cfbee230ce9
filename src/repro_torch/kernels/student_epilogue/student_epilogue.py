"""The Fig. 5 student's convolution epilogues in one pass on the card:
`conv_epilogue` runs a convolution, then bias and ReLU, and with ``bn``
eval BatchNorm and the 2x2 max-pool (floor: 30 -> 15, 15 -> 7), writing
only the result (conv1, conv2: with ``bn``; conv3, conv4: without;
``flatten`` gives the (B, H * W * C) NHWC-flat features that
`Student.features` returns). It comes in two versions in this module:

  * a **plain PyTorch** version (`conv_epilogue_plain`): the chain
    `Student.features` runs everywhere else, ``F.conv2d`` with its bias,
    ``F.relu``, `cnn.batchnorm` in eval mode, ``F.max_pool2d``;
  * a **CUDA wrapper** (`conv_epilogue`): the convolution without its
    bias (cuDNN, as before), then one launch of `csrc/student_epilogue.cu`
    on its raw output (`epilogue`), the same arithmetic bit for bit.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Each launch adds one to
``LAUNCHES["student_epilogue"]``. The kernel replaces no Pallas kernel (the
JAX package left these ops to XLA). It reads the convolution's output in
the channels-last format cuDNN gives the student (its first input is a
permuted NHWC batch) and raises on any other; it writes the format the
plain chain's pool or ReLU writes, so the next convolution sees the same
input.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import _build

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"student_epilogue": 0}


def reset_launches() -> None:
    LAUNCHES["student_epilogue"] = 0


def conv_epilogue_plain(h: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, padding,
                        bn: nn.BatchNorm2d | None = None, *,
                        flatten: bool = False) -> torch.Tensor:
    """``relu(conv2d(h) + bias)``; with ``bn`` then eval BatchNorm and
    ``max_pool2d(., 2)``; ``flatten``: as (B, H * W * C), NHWC."""
    h = F.relu(F.conv2d(h, weight, bias, padding=padding))
    if bn is not None:
        from repro_torch.models import cnn  # cnn imports this module

        h = F.max_pool2d(cnn.batchnorm(bn, h, train=False), 2)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1) if flatten else h


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # in, bias, mu, inv, scale, shift, out, B, H, W, C, pool, stream
    "student_epilogue": [_P] * 7 + [_I] * 5 + [_P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("student_epilogue", _SIGNATURES)


def _channel_params(raw: torch.Tensor, **params: torch.Tensor) -> None:
    c = raw.shape[1]
    for name, p in params.items():
        if p.device != raw.device or p.dtype != torch.float32 \
                or tuple(p.shape) != (c,) or not p.is_contiguous():
            raise ValueError(f"{name}: {tuple(p.shape)} {p.dtype} on "
                             f"{p.device}, expected contiguous ({c},) "
                             f"float32 on {raw.device}")


def epilogue(raw: torch.Tensor, bias: torch.Tensor,
             bn: nn.BatchNorm2d | None = None, *, flatten: bool = False
             ) -> torch.Tensor:
    """One launch on ``raw``, a (B, C, H, W) float32 channels-last conv
    output on the card without its bias: bias and ReLU, and with ``bn``
    eval BatchNorm and the 2x2 pool (H // 2, W // 2). The result is
    channels-last (B, C, H', W'), or with ``flatten`` the same bytes as
    (B, H' * W' * C)."""
    device = raw.device
    if device.type != "cuda":
        raise ValueError(f"conv output on {device}: the kernel takes CUDA "
                         "tensors")
    if raw.dtype != torch.float32 or raw.dim() != 4:
        raise TypeError(f"conv output {raw.dtype} {tuple(raw.shape)}: the "
                        "kernel takes (B, C, H, W) float32")
    if not raw.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv output strides {raw.stride()} at "
                         f"{tuple(raw.shape)}: the kernel reads channels-"
                         "last (NHWC) only")
    b, c, h, w = raw.shape
    params = [None] * 4
    if bn is None:
        _channel_params(raw, bias=bias)
        ho, wo = h, w
    else:
        inv = torch.rsqrt(bn.running_var + bn.eps)  # as `cnn.batchnorm`
        params = [bn.running_mean, inv, bn.weight, bn.bias]
        _channel_params(raw, bias=bias, running_mean=bn.running_mean,
                        inv=inv, weight=bn.weight, bn_bias=bn.bias)
        ho, wo = h // 2, w // 2
    if flatten:
        out = torch.empty((b, ho * wo * c), dtype=raw.dtype, device=device)
    else:
        out = torch.empty((b, c, ho, wo), dtype=raw.dtype, device=device,
                          memory_format=torch.channels_last)
    _build.launch(_lib(), "student_epilogue", device, LAUNCHES,
                  raw.data_ptr(), bias.data_ptr(),
                  *(None if p is None else p.data_ptr() for p in params),
                  out.data_ptr(), b, h, w, c, int(bn is not None))
    return out


def conv_epilogue(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  padding, bn: nn.BatchNorm2d | None = None, *,
                  flatten: bool = False) -> torch.Tensor:
    """`conv_epilogue_plain`; on the card the conv without its bias, then
    one fused launch."""
    if h.device.type == "cpu":
        return conv_epilogue_plain(h, weight, bias, padding, bn,
                                   flatten=flatten)
    return epilogue(F.conv2d(h, weight, None, padding=padding), bias, bn,
                    flatten=flatten)
