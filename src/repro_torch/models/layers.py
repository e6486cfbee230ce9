"""Shared neural layers for the LM zoo, in PyTorch: `chunked_attention`.

The rest of the JAX package's `repro/models/layers.py` (norms, rotary
embeddings, `decode_attention`, MoE, MLA, Mamba2) comes with the LM slice of
the port.
"""
from __future__ import annotations

import torch


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
