"""The precision a reference computes in.

The benchmark's references run in float64: the answer the float32
program rounds towards. The control of each cell runs the same reference
code one step below what the configurations state (float32 with TF32 off):
float32 with TF32 products. On the card that is cuDNN's and cuBLAS's own
TF32; the operands of every convolution and product are also rounded to
TF32 here (10 mantissa bits, to nearest even), which is what the tensor
cores read, so the control loses the same bits on the CPU in the tests.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest even
    (finite values; TF32 keeps float32's exponent)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a convolution or product (the rounding passes
        gradients straight through)."""
        if not self.tf32:
            return t
        r = tf32_round(t.detach())
        return t + (r - t.detach()) if t.requires_grad else r

    @contextlib.contextmanager
    def flags(self):
        """The card's TF32 switches as this precision wants them, restored
        on exit."""
        matmul = torch.backends.cuda.matmul
        prev = matmul.allow_tf32
        matmul.allow_tf32 = self.tf32
        try:
            with torch.backends.cudnn.flags(
                    enabled=torch.backends.cudnn.enabled, benchmark=False,
                    deterministic=True, allow_tf32=self.tf32):
                yield
        finally:
            matmul.allow_tf32 = prev


#: the reference
F64 = Precision(torch.float64, False)
#: the control: float32 with TF32 products
TF32 = Precision(torch.float32, True)
