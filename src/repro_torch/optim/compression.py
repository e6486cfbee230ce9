"""Gradient compression: int8 quantisation with a per-tensor scale and
error feedback, the JAX package's `repro/optim/compression.py`.

Each gradient plus the error carried from the last step is quantised to
int8 against ``max|x| / 127`` (rounding half to even, as ``jnp.round``),
dequantised, and the difference carried into the next step:

    grads_q, new_err = compress_decompress(grads, err_state)

On one card nothing crosses a reduction; the step applies the
dequantised gradients, so training follows the compressed run exactly.
Gradients and errors are dicts of tensors keyed alike; each entry is one
tensor with one scale, so a caller whose JAX tree stacks tensors (the
LM's layers) passes them stacked (`repro_torch.convert.lm_stack`).
"""
from __future__ import annotations

import torch

Params = dict[str, torch.Tensor]


def init_error_state(params: Params) -> Params:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp_min(x.abs().max(), 1e-12)
    # a device divisor: CUDA turns a Python scalar's division into a
    # product by its reciprocal, one ulp off the quotient
    scale = amax / torch.tensor(127.0, device=x.device)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


def compress_decompress(grads: Params, err: Params
                        ) -> tuple[Params, Params]:
    """Quantise (grad + carried error) to int8; return the dequantised
    gradients actually applied (in each gradient's dtype) and the new
    error carry (f32)."""
    out, new_err = {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + err[k]
        q, scale = _q8(g32)
        deq = q.to(torch.float32) * scale
        out[k], new_err[k] = deq.to(g.dtype), g32 - deq
    return out, new_err


def compression_ratio(grads: Params, *, from_dtype_bytes: int = 4) -> float:
    """Collective-traffic reduction factor (int8 payload + one f32 scale
    a tensor)."""
    total = sum(g.numel() for g in grads.values())
    return (total * from_dtype_bytes) / (total * 1 + 4 * len(grads))
