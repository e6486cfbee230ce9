"""MLA prefill attention on the card: causal softmax(q k^T * scale) v at
DeepSeek-V2/V3's multi-head latent attention widths, with q and k each in
two parts and the rope part of k shared by every head:

    q_nope (B, S, H, 128), q_rope (B, S, H, 64), k_nope (B, S, H, 128),
    k_rope (B, S, 64), v (B, S, H, 128) -> (B, S, H, 128)

The score of query row i and key j in head h is
``(q_nope[i, h] . k_nope[j, h] + q_rope[i, h] . k_rope[j]) * scale`` in
float32, keys j > i hidden (Sq == Sk: prefill from position 0). It comes in
two versions in this module:

  * a **plain PyTorch** version (`mla_prefill_plain`): the kernel's
    arithmetic without its tiles: scores from the operands' values in f32,
    the row max, ``p = exp(s - m)`` and its f32 row sum ``l``, ``p`` cast
    to v's dtype before P.V in f32, the division by ``l`` last;
  * a **CUDA wrapper** (`mla_prefill`): one launch of `csrc/mla_prefill.cu`
    (TMA-fed K/V tiles, wgmma, online softmax, causal tiles skipped), which
    reads each operand through its strides (the views of the projections'
    outputs, no copy) and writes a contiguous bf16 output.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises: bf16 only, the widths above, the
last dim contiguous, the other strides and the base addresses 16-byte
aligned. Each launch adds one to ``LAUNCHES["mla_prefill"]``. The kernel
has no backward and replaces no Pallas kernel (the JAX package's MLA path
runs plain `chunked_attention`): `models.lm._mla_train_attention` takes it
on the card without grad, and `chunked_attention` everywhere else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: (qk nope, qk rope, v) head widths the kernel is built for: DeepSeek-V2
#: and V3's published MLA
WIDTHS = (128, 64, 128)
#: kernel launches since the last `reset_launches()`
LAUNCHES = {"mla_prefill": 0}


def reset_launches() -> None:
    LAUNCHES["mla_prefill"] = 0


def mla_prefill_plain(q_nope: torch.Tensor, q_rope: torch.Tensor,
                      k_nope: torch.Tensor, k_rope: torch.Tensor,
                      v: torch.Tensor, *, scale: float,
                      q_chunk: int = 512) -> torch.Tensor:
    """The kernel's arithmetic without its tiles, ``q_chunk`` query rows
    at a time -> (B, S, H, dv) in v's dtype. Any widths."""
    f32 = torch.float32
    b, s, h, _ = q_nope.shape
    kn, kr, vf = k_nope.to(f32), k_rope.to(f32), v.to(f32)
    kpos = torch.arange(s, device=q_nope.device)
    outs = []
    for c0 in range(0, s, q_chunk):
        qn = q_nope[:, c0:c0 + q_chunk].to(f32)
        qr = q_rope[:, c0:c0 + q_chunk].to(f32)
        n = qn.shape[1]
        logits = (torch.einsum("bqhd,bkhd->bhqk", qn, kn)
                  + torch.einsum("bqhd,bkd->bhqk", qr, kr)) * scale
        qpos = c0 + torch.arange(n, device=q_nope.device)
        live = kpos[None, :] <= qpos[:, None]
        logits = torch.where(live, logits, float("-inf"))
        m = logits.amax(dim=-1, keepdim=True).clamp(min=-1e30)
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(f32), vf)
        o = torch.where(l > 0, o / l, 0.0)
        outs.append(o.permute(0, 2, 1, 3).to(v.dtype))
    if not outs:
        return v.new_zeros((b, 0, h, v.shape[-1]))
    return torch.cat(outs, dim=1)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # q_nope, q_rope, k_nope, k_rope, v, out, B, S, H, 14 element strides
    # (head, row, batch of q_nope, q_rope, k_nope; row, batch of k_rope;
    # head, row, batch of v), scale, stream
    "mla_prefill": [_P] * 6 + [_I] * 3 + [_L] * 14 + [ctypes.c_float, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("mla_prefill", _SIGNATURES)


def _strides(name: str, x: torch.Tensor) -> list[int]:
    """``x``'s element strides but the last, innermost first: (head, row,
    batch) or (row, batch), each of a size-1 dim replaced by one the
    tensor map accepts (it is never stepped)."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: strides {x.stride()}, the last dim must "
                         "be contiguous")
    out = []
    for dim in range(x.dim() - 2, -1, -1):
        st = x.stride(dim)
        if x.shape[dim] == 1:
            st = x.shape[dim + 1] * (out[-1] if out else 1)
            st = -(-st // 8) * 8
        if st % 8 or st <= 0:
            raise ValueError(f"{name}: strides {x.stride()}: the kernel "
                             "reads 16-byte aligned rows")
        out.append(st)
    return out


def _launch_args(q_nope: torch.Tensor, q_rope: torch.Tensor,
                 k_nope: torch.Tensor, k_rope: torch.Tensor,
                 v: torch.Tensor) -> tuple[int, int, int, list[int]]:
    """(B, S, H, the 14 element strides) of a launch, or raise on what the
    kernel does not take: the widths, bf16, one device, the strides and
    alignment. No limit on B or H: the grid is flat."""
    if q_nope.dim() != 4:
        raise ValueError(f"q_nope must be (B, S, H, {WIDTHS[0]}), got "
                         f"{tuple(q_nope.shape)}")
    b, s, h, _ = q_nope.shape
    nope, rope, dv = WIDTHS
    want = {"q_nope": (q_nope, (b, s, h, nope)),
            "q_rope": (q_rope, (b, s, h, rope)),
            "k_nope": (k_nope, (b, s, h, nope)),
            "k_rope": (k_rope, (b, s, rope)), "v": (v, (b, s, h, dv))}
    strides = []
    for name, (x, shape) in want.items():
        if x.device != q_nope.device or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {tuple(x.shape)} on {x.device}, "
                             f"expected {shape} on {q_nope.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {x.dtype}: the kernel takes "
                            "bfloat16")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
        strides += _strides(name, x)
    if s < 1:
        raise ValueError("attention needs at least one key")
    return b, s, h, strides


def mla_prefill(q_nope: torch.Tensor, q_rope: torch.Tensor,
                k_nope: torch.Tensor, k_rope: torch.Tensor, v: torch.Tensor,
                *, scale: float) -> torch.Tensor:
    """`mla_prefill_plain` on the CPU; on the card one launch of the
    kernel -> (B, S, H, 128) bf16, contiguous."""
    if q_nope.device.type == "cpu":
        return mla_prefill_plain(q_nope, q_rope, k_nope, k_rope, v,
                                 scale=scale)
    device = q_nope.device
    if device.type != "cuda":
        raise ValueError(f"q_nope on {device}: the kernel takes CUDA or CPU "
                         "tensors")
    b, s, h, strides = _launch_args(q_nope, q_rope, k_nope, k_rope, v)
    out = torch.empty((b, s, h, WIDTHS[2]), dtype=torch.bfloat16,
                      device=device)
    _build.launch(_lib(), "mla_prefill", device, LAUNCHES,
                  q_nope.data_ptr(), q_rope.data_ptr(), k_nope.data_ptr(),
                  k_rope.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
                  *strides, float(scale))
    return out
