"""The fused knowledge-distillation loss kernel (B8, paper Eq. 1-3):

    L_i = alpha * T^2 * KL(sigma(z_t/T) || sigma(z_s/T))
        + (1 - alpha) * CE(z_s, y_i)

per sample i, for (B, V) student and teacher logits (f32, bf16 or f16,
read as f32) and int labels; out (B,) f32. It keeps the signature of its
Pallas TPU counterpart, `repro/kernels/kd_loss/kd_loss.py` (`kd_loss`),
and comes in two versions in this module:

  * a **plain PyTorch** version (`kd_loss_plain`): log-softmaxes in f32,
    with the TPU kernel's CE pick: a one-hot over the V columns, so a label
    outside ``[0, V)`` picks 0 (and its CE is the log-sum-exp alone);
  * a **CUDA wrapper** (`kd_loss`) over `csrc/kd_loss.cu`: one block per
    row streams the row once with the kernel's online (rescaled)
    accumulators.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises. Each launch adds one to
``LAUNCHES["kd_loss"]``. ``block`` and ``interpret`` are the Pallas tiling
arguments, accepted for signature parity and ignored.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK = (256, 2048)  # the TPU kernel's (rows, vocab tile)

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"kd_loss": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    LAUNCHES["kd_loss"] = 0


def kd_loss_plain(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                  labels: torch.Tensor, *, temperature: float = 4.0,
                  alpha: float = 0.5) -> torch.Tensor:
    """Per-sample Eq. 1 (B,) in f32, the label picked by a one-hot."""
    zs = student_logits.to(torch.float32)
    zt = teacher_logits.to(torch.float32)
    log_ps = torch.log_softmax(zs / temperature, dim=-1)
    log_pt = torch.log_softmax(zt / temperature, dim=-1)
    kl = torch.sum(torch.exp(log_pt) * (log_pt - log_ps), dim=-1)
    cols = torch.arange(zs.shape[-1], device=zs.device)
    picked = torch.sum(torch.where(cols == labels[:, None].long(), zs, 0.0),
                       dim=-1)
    ce = torch.logsumexp(zs, dim=-1) - picked
    return (alpha * temperature**2) * kl + (1.0 - alpha) * ce


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # zs, zt, labels, B, V, dtype, temperature, coef_kl, coef_ce, out, stream
    "kd_loss": [_P] * 3 + [_I] * 3 + [_F] * 3 + [_P] * 2,
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("kd_loss", _SIGNATURES)


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            labels: torch.Tensor, *, temperature: float = 4.0,
            alpha: float = 0.5, block=DEFAULT_BLOCK,
            interpret: bool = False) -> torch.Tensor:
    """Per-sample fused distillation loss (B,) f32 of (B, V) logits."""
    if student_logits.device.type == "cpu":
        return kd_loss_plain(student_logits, teacher_logits, labels,
                             temperature=temperature, alpha=alpha)
    device = student_logits.device
    if device.type != "cuda":
        raise ValueError(f"logits on {device}: the kernel takes CUDA or CPU "
                         "tensors")
    if student_logits.dim() != 2:
        raise ValueError(f"logits must be (B, V), got "
                         f"{tuple(student_logits.shape)}")
    b, v = student_logits.shape
    for name, z in (("student_logits", student_logits),
                    ("teacher_logits", teacher_logits)):
        if z.device != device or tuple(z.shape) != (b, v):
            raise ValueError(f"{name}: {tuple(z.shape)} on {z.device}, "
                             f"expected {(b, v)} on {device}")
        if z.dtype != student_logits.dtype or z.dtype not in _DTYPES:
            raise TypeError(f"{name} is {z.dtype}: both logits must share "
                            "one of float32, bfloat16, float16")
        if not z.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if labels.device != device or tuple(labels.shape) != (b,) \
            or labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"labels: {tuple(labels.shape)} {labels.dtype} on "
                         f"{labels.device}, expected ({b},) int on {device}")
    if v < 1:
        raise ValueError("logits need at least one column")
    labels = labels.to(torch.int32).contiguous()
    out = torch.empty(b, dtype=torch.float32, device=device)
    if b:
        with torch.cuda.device(device):
            rc = _lib().kd_loss(
                student_logits.data_ptr(), teacher_logits.data_ptr(),
                labels.data_ptr(), b, v, _DTYPES[student_logits.dtype],
                temperature, alpha * temperature**2, 1.0 - alpha,
                out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kd_loss: CUDA error {rc} at launch")
        LAUNCHES["kd_loss"] += 1
    return out
