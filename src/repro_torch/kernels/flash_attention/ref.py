"""Plain-PyTorch oracle of the flash_attention kernel, as the JAX package's
`attention_ref` writes it: softmax attention in f32 with a -inf causal mask,
output in q's dtype."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, D). Plain softmax attention in f32."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * (d ** -0.5)
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sk, device=s.device)[None, :]
                <= torch.arange(sq, device=s.device)[:, None])
        s = torch.where(mask[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
