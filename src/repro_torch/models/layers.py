"""Shared neural layers for the LM zoo, in PyTorch.

The dense half of the JAX package's `repro/models/layers.py`: RMSNorm /
LayerNorm, rotary embeddings (standard and qwen2-vl's M-RoPE), linear
layers with an optional bias, `chunked_attention` (prefill) and
`decode_attention` (one token against a cache), and the SwiGLU MLP. Each
parametrised layer is an `nn.Module` whose parameters carry the JAX leaf
names and layouts (a linear weight is ``w`` of shape (din, dout)), so a
JAX pytree maps onto it name by name (`repro_torch.convert`); the
functions take the module in place of the JAX dict. ``*_init`` draws the
JAX package's distributions from an explicit `torch.Generator` on the
generator's device (not the JAX values).

The dtype order is the JAX package's: norms and rotary embeddings compute
in f32 and cast back; products with bf16 operands accumulate in f32
(``preferred_element_type``) from the operands' own values.

MoE, MLA and the Mamba2 SSD functions come with later slices of the port
(ROADMAP §A); `SSMSpec` is here for `ArchConfig.param_count`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """A unit ``scale``, on ``device`` (the card unless the CPU is asked)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((d,), dtype=torch.float32,
                                             device=resolve(device)),
                                  requires_grad=False)


def rmsnorm_init(d: int, *, device=None) -> RMSNorm:
    return RMSNorm(d, device=device)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``(x * rsqrt(mean(x**2) + eps))`` in f32, cast to x's dtype, THEN
    times ``scale`` cast to x's dtype (the JAX order)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.scale.to(x.dtype)


class LayerNorm(nn.Module):
    """A unit ``scale`` and a zero ``bias``, on ``device`` (the card unless
    the CPU is asked)."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        device = resolve(device)
        self.scale = nn.Parameter(torch.ones((d,), dtype=torch.float32,
                                             device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros((d,), dtype=torch.float32,
                                             device=device),
                                 requires_grad=False)


def layernorm_init(d: int, *, device=None) -> LayerNorm:
    return LayerNorm(d, device=device)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    device = resolve(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (B, S, D/2), built once per step
    (`ArchConfig.precompute_rope`)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               tables: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta)
    return _rotate(x, tables[0][:, :, None, :], tables[1][:, :, None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """M-RoPE (qwen2-vl): positions (3, B, S) = (temporal, height, width);
    the D/2 frequency slots split into 3 sections, each driven by its own
    position stream. ``sections`` sums to D/2."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])
    pos_bsd = torch.movedim(positions, 0, -1).to(torch.float32)  # (B, S, 3)
    angles = pos_bsd[..., sec] * freqs  # (B, S, D/2)
    return _rotate(x, torch.cos(angles)[:, :, None, :],
                   torch.sin(angles)[:, :, None, :])


# ---------------------------------------------------------------------------
# dense / attention
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` (din, dout): the JAX layout."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b, requires_grad=False)


def linear_init(generator: torch.Generator, din: int, dout: int, *,
                bias: bool = False, dtype=torch.bfloat16) -> Linear:
    """Normal weights times ``din ** -0.5``; a zero bias."""
    w = (_normal((din, dout), generator) * (din ** -0.5)).to(dtype)
    b = torch.zeros((dout,), dtype=dtype, device=generator.device) \
        if bias else None
    return Linear(w, b)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_chunk: int = 512,
                      window: int | None = None, q_offset=0
                      ) -> torch.Tensor:
    """Flash-style attention with O(S_q / chunk) temporaries (plain torch).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H = KV * G; kv heads are
    repeated to full heads. Each q-chunk attends to all of k under the mask.
    Scores and the probability-weighted sum accumulate in f32 from the
    operands' own values (as the JAX package's ``preferred_element_type``);
    the probabilities are cast to v's dtype first and the output is in v's
    dtype. `window` adds sliding-window masking; `q_offset` positions q
    within the kv stream. Fully masked rows give zeros, not NaN. One device:
    the JAX package's mesh constraint has no counterpart here.
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]  # may differ from d (MLA: qk-dim 192, v-dim 128)
    g = h // kv
    scale = d ** -0.5
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(sk, device=q.device)
    q_offset = torch.as_tensor(q_offset, device=q.device)
    outs = []
    for c0 in range(0, sq, q_chunk):
        qi = q[:, c0:c0 + q_chunk]
        n = qi.shape[1]
        logits = torch.einsum("bqhd,bshd->bhqs", qi.to(torch.float32),
                              kf) * scale
        qpos = q_offset + c0 + torch.arange(n, device=q.device)
        mask = torch.ones((n, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask[None, None], logits, float("-inf"))
        att = torch.softmax(logits, dim=-1)
        # fully-masked rows (padding) produce nan-free zeros:
        att = torch.where(mask.any(dim=-1)[None, None, :, None], att, 0.0)
        out = torch.einsum("bhqs,bshd->bqhd",
                           att.to(v.dtype).to(torch.float32), vf)
        outs.append(out.to(v.dtype))
    if not outs:
        return q.new_zeros((b, 0, h, dv), dtype=v.dtype)
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int) -> torch.Tensor:
    """Single-token attention against a (B, Smax, KV, D) cache.

    q: (B, 1, H, D); only slots < ``cur_len`` are attended (ring-buffer
    callers pass the buffer's fill level). Scores in f32 from the operands'
    values, softmax in f32, probabilities cast to v's dtype, output in v's
    dtype.
    """
    b, _, h, d = q.shape
    _, smax, kv, _ = k_cache.shape
    g = h // kv
    qr = q.reshape(b, kv, g, d).to(torch.float32)
    logits = torch.einsum("bkgd,bskd->bkgs", qr,
                          k_cache.to(torch.float32)) * (d ** -0.5)
    mask = torch.arange(smax, device=q.device) < cur_len
    logits = torch.where(mask, logits, float("-inf"))
    att = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd",
                       att.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, h, d).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, gate: Linear, up: Linear, down: Linear):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down


def mlp_init(generator: torch.Generator, d: int, d_ff: int,
             dtype=torch.bfloat16) -> MLP:
    return MLP(linear_init(generator, d, d_ff, dtype=dtype),
               linear_init(generator, d, d_ff, dtype=dtype),
               linear_init(generator, d_ff, d, dtype=dtype))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it: ``x * (1 / (1 + exp(-x)))`` with
    every op rounded to x's dtype (`torch.nn.functional.silu` rounds once,
    and differs from it by up to 2 bf16 ulps)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return linear(p.down, silu(linear(p.gate, x)) * linear(p.up, x))


# ---------------------------------------------------------------------------
# Mamba2 SSD geometry (the SSD functions come with a later slice)
# ---------------------------------------------------------------------------

class SSMSpec(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    conv_kernel: int = 4
    chunk: int = 256
