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
  * a **CUDA wrapper** (`kd_loss`) over `csrc/kd_loss.cu`, one launch per
    call: a warp per row for short rows (up to `WARP_ROW_COLS` columns, the
    trainer's V = 10), else each row split into `split_plan` runs of
    columns, a block each, whose partial accumulators the last block of the
    row merges in a fixed order (deterministic).

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

#: rows of at most this many columns take a warp each (the kernel's
#: rows_kernel); longer ones are split across blocks (split_kernel)
WARP_ROW_COLS = 1024
#: a split keeps at least this many columns ...
MIN_SPLIT_COLS = 1024
#: ... and the splits aim at no more than this many blocks per SM (the
#: split kernel's residency on the H100: a second wave would double the time)
SPLIT_BLOCKS_PER_SM = 2
#: split lengths are multiples of one 16-byte vector of 16-bit logits
SPLIT_ALIGN = 8
#: the H100's SMs (`split_plan`'s default; the wrapper reads the card's)
H100_SMS = 132

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


def split_cols(v: int, splits: int) -> int:
    """Columns per split of a V-column row in ``splits`` runs: ceil(V / S)
    rounded up to `SPLIT_ALIGN` (the last runs may be short or empty)."""
    cols = -(-v // max(splits, 1))
    return -(-cols // SPLIT_ALIGN) * SPLIT_ALIGN


def split_plan(b: int, v: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(S, L): the split kernel's S runs of L columns per row. S fills up
    to `SPLIT_BLOCKS_PER_SM` blocks per SM over the B rows, keeps
    `MIN_SPLIT_COLS` columns a run, and is at least 1; L is `split_cols`,
    and S = ceil(V / L), so no run starts past V."""
    s = max(1, min(SPLIT_BLOCKS_PER_SM * sms // max(b, 1),
                   v // MIN_SPLIT_COLS))
    cols = split_cols(v, s)
    return -(-v // cols), cols


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: arrival counters of the split kernel per (device, stream): zero between
#: launches (the last block of each row resets its own)
_COUNTERS: dict = {}


def _counters(device: torch.device, stream: int, rows: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < rows:
        buf = _COUNTERS[key] = torch.zeros(max(rows, 256), dtype=torch.int32,
                                           device=device)
    return buf


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # zs, zt, labels, B, V, dtype, splits, split_cols, temperature,
    # coef_kl, coef_ce, work, counters, out, stream
    "kd_loss": [_P] * 3 + [_I] * 5 + [_F] * 3 + [_P] * 4,
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
    splits, cols = ((0, v) if v <= WARP_ROW_COLS
                    else split_plan(b, v, _sms(device.index)))
    work = b * splits * 8 if splits > 1 else 0  # one Partial a split
    buf = torch.empty(b + work, dtype=torch.float32, device=device)
    if b:
        counters = (_counters(device, _build.stream(device), b).data_ptr()
                    if work else None)
        _build.launch(_lib(), "kd_loss", device, LAUNCHES,
                      student_logits.data_ptr(), teacher_logits.data_ptr(),
                      labels.data_ptr(), b, v, _DTYPES[student_logits.dtype],
                      splits, cols, temperature, alpha * temperature**2,
                      1.0 - alpha, buf.data_ptr() + 4 * b if work else None,
                      counters, buf.data_ptr())
    return buf[:b]
