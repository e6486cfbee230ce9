"""The flash attention forward kernel (B9): softmax(q k^T * d^-0.5) v with
an online softmax and an optional causal mask.

Two faces of one CUDA kernel (`csrc/flash_attention.cu`), both counted in
``LAUNCHES["flash_attention"]``:

  * `flash_attention(q, k, v)` keeps the signature of its Pallas TPU
    counterpart, `repro/kernels/flash_attention/flash_attention.py`
    (`flash_attention`): q, k, v (BH, S, D), heads flattened into the batch;
  * `flash_attention_gqa(q, k, v)` takes the model layout, q (B, S, H, D)
    and k, v (B, S, KV, D), and reads kv head h / (H / KV) for query head
    h, so grouped-query attention needs no repeated copy of k and v.

Each comes with a **plain PyTorch** version (``*_plain``) that keeps the
TPU kernel's numerics: the finite mask -1e30 for hidden keys, p rounded to
v's dtype before P.V, f32 accumulation, l clamped at 1e-30, the output in
q's dtype. The wrappers take the plain version only for tensors on the CPU;
for CUDA tensors they launch the kernel or raise. ``block`` and
``interpret`` are the Pallas tiling arguments, accepted for signature
parity and ignored. Head dims 32, 64, 96 and 128 are supported on the card.

`route` names the kernel a (dtype, head dim) runs on the card: bf16 and
f16 on the tensor cores (``mma.sync``, f32 accumulation, 64 query rows by
64 keys per step), f32 on FP32 FMAs (tensor cores would compute f32 as
TF32, outside the 2e-3 the JAX package holds f32 attention to).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK = (512, 512)  # the TPU kernel's (bq, bk)
NEG = -1e30
HEAD_DIMS = (32, 64, 96, 128)

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TENSOR_CORE, FP32 = "tensor_core", "fp32"


def route(dtype: torch.dtype, d: int) -> str:
    """The card's kernel for ``dtype`` operands of head dim ``d``:
    `TENSOR_CORE` for bf16 and f16, `FP32` for f32. Raises for anything the
    kernel does not take."""
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention supports head dims {HEAD_DIMS} "
                         f"on the card, got {d}")
    if dtype in (torch.bfloat16, torch.float16):
        return TENSOR_CORE
    if dtype == torch.float32:
        return FP32
    raise TypeError(f"q is {dtype}: q, k and v must share one of float32, "
                    "bfloat16, float16")


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True
                          ) -> torch.Tensor:
    """(BH, Sq, D) x (BH, Sk, D) -> (BH, Sq, D), the kernel's arithmetic
    without its tiles."""
    d, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(1, 2)) * (d ** -0.5)
    if causal:
        mask = (torch.arange(sk, device=s.device)[None, :]
                <= torch.arange(sq, device=s.device)[:, None])
        s = torch.where(mask[None], s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_gqa_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, KV, D) -> (B, Sq, H, D): kv heads repeated,
    heads flattened into the batch, then `flash_attention_plain`."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    q3 = q.permute(0, 2, 1, 3).reshape(b * h, sq, d)
    k3 = k.permute(0, 2, 1, 3).reshape(b * h, -1, d)
    v3 = v.permute(0, 2, 1, 3).reshape(b * h, -1, d)
    o = flash_attention_plain(q3, k3, v3, causal=causal)
    return o.reshape(b, h, sq, d).permute(0, 2, 1, 3)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, B, Sq, Sk, H, KV, D, dtype, causal, scale, stream
    "flash_attention": [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _build.bind("flash_attention", _SIGNATURES)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """Validate (B, Sq, H, D) / (B, Sk, KV, D) operands and launch the
    kernel `route` names."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"q on {device}: the kernel takes CUDA or CPU "
                         "tensors")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, D) / (B, S, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    path = route(q.dtype, d)
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} kv "
                         "heads")
    if path == FP32 and b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid limit 65535")
    if path == TENSOR_CORE and -(-sq // 64) > 65535:
        raise ValueError(f"{sq} query rows exceed the grid limit of 65535 "
                         "tiles of 64")
    for name, x, shape in (("q", q, (b, sq, h, d)), ("k", k, (b, sk, kv, d)),
                           ("v", v, (b, sk, kv, d))):
        if x.device != device or x.shape != shape:
            raise ValueError(f"{name}: {tuple(x.shape)} on {x.device}, "
                             f"expected {shape} on {device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}: q, k and v must share one "
                            "of float32, bfloat16, float16")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if path == TENSOR_CORE and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "copies 16-byte chunks)")
    if sk < 1:
        raise ValueError("attention needs at least one key")
    out = torch.empty_like(q)
    if b and sq:
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                sq, sk, h, kv, d, _DTYPES[q.dtype], int(causal), d ** -0.5,
                _build.stream(device))
        fn = _lib().flash_attention
        if device.index == torch.cuda.current_device():
            rc = fn(*args)
        else:
            with torch.cuda.device(device):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"flash_attention: CUDA error {rc} at launch")
        LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block=DEFAULT_BLOCK,
                    interpret: bool = False) -> torch.Tensor:
    """q, k, v: (BH, S, D) (heads pre-flattened into batch). Returns
    (BH, Sq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, D), got {tuple(q.shape)}")
    return _launch(q[:, :, None], k[:, :, None], v[:, :, None],
                   causal)[:, :, 0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, KV, D) -> (B, Sq, H, D) in q's dtype; query
    head h attends with kv head h / (H / KV)."""
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal=causal)
    return _launch(q, k, v, causal)
