"""DeepSeek-V3's forward pass, written from its published description in
plain PyTorch: one sequence at a time, no cache, no batching, no kernels.

Sources: the model's config.json
(https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json, whose
key names ``cfg`` uses) and arXiv:2412.19437: §2.1.1 multi-head latent
attention, §2.1.2 DeepSeekMoE with the auxiliary-loss-free router (sigmoid
affinities; a per-expert bias added for the choice alone; the chosen
affinities normalised), node-limited routing as the config's ``n_group`` /
``topk_group`` state it (a group scores the sum of its two highest biased
affinities), ``routed_scaling_factor`` on the weights, the first
``first_k_dense_replace`` layers dense; YaRN (``rope_scaling``) on the
decoupled rope dims, its ``mscale_all_dim`` squared on the softmax scale.

Arithmetic: every product, sum, norm, attention score, softmax and the
router in float32 from the float32 values of the weights, TF32 off.
`Precision.act` rounds each tensor the configuration stores in a narrower
type to it, once per operation that makes one, as a bf16 deployment
stores them: each linear layer's, norm's (before and after its scale),
rotation's and attention's output, the softmax probabilities, each of
silu's elementwise operations and the gated product, each expert's output
times its weight and each addition of the weighted sum, and the residual
stream after each addition. `Precision.acc`, below float32, rounds the
attention scores and the router's logits to it, as a GEMM that writes
that type rounds its float32 sums, the router's weight rounded to it
first: the control a check must reject.

Departures from the published model, each with its reason:

- The multi-token-prediction module is left out: a forward pass for
  features or for the next token never runs it.
- Weights in bf16 stand for the FP8 checkpoint, as the official
  ``fp8_cast_bf16`` conversion makes them; they are read in float32.
- One chip's share of the experts (``cfg["n_routed_experts"]`` of the
  ``cfg["router_experts"]`` the router spans, from ``expert_offset``) is
  computed, as expert parallelism computes it; the rest add nothing here.
- The rotation pairs dims ``(2i, 2i + 1)`` (the published layout). A model
  that rotates halves (dims ``i`` and ``i + D/2``) is the same model with
  the rope columns of its ``q_b`` / ``kv_a`` permuted:
  `interleave_rope_columns` maps its weights here.
- Attention scores are accumulated in float32, as the configuration states
  (the official inference code rounds them to bf16).
- silu is ``x * (1 / (1 + exp(-x)))`` with each operation rounded, as the
  JAX program and XLA compute it (the official code rounds
  ``F.silu(x)`` once); in float32 the two agree to an ulp.

Weights: a dict with ``embed`` (V, d), ``final_norm`` (d,), ``unembed``
(d, V) and ``layers``, one dict a layer: ``attn_norm``, ``q_a`` (d,
q_lora), ``q_a_norm``, ``q_b`` (q_lora, H (nope + rope)), ``kv_a`` (d,
kv_lora + rope), ``kv_a_norm``, ``kv_b`` (kv_lora, H (nope + v)), ``o`` (H
v, d), ``ffn_norm``; a dense layer ``gate`` / ``up`` (d, f) and ``down``
(f, d); an MoE layer ``router`` (d, E), ``bias`` (E,), ``experts_gate`` /
``experts_up`` (n, d, f), ``experts_down`` (n, f, d) and ``shared_gate``,
``shared_up``, ``shared_down``. Every matrix maps its input on the left
(``x @ w``).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

F32 = torch.float32


class Precision(NamedTuple):
    act: torch.dtype | None  # activations rounded to this (None: float32)
    acc: torch.dtype = F32  # attention scores and router logits

    def round(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.act is None else t.to(self.act).to(F32)

    def round_acc(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.acc == F32 else t.to(self.acc).to(F32)


#: the configuration's precision: bf16 activations, float32 scores and router
BF16 = Precision(torch.bfloat16)
#: float32 throughout
FLOAT32 = Precision(None)
#: one step below the configuration's: scores and router logits in bf16
BF16_ACC = Precision(torch.bfloat16, torch.bfloat16)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 on the card, restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def interleave_rope_columns(w: torch.Tensor, block: int, rope: int
                            ) -> torch.Tensor:
    """``w``'s columns in blocks of ``block`` (a head's, or kv_a's whole
    row), the last ``rope`` of each block in the half-split order (dims
    ``i`` and ``i + rope/2`` rotate together), put in the pair order used
    here (dims ``2i`` and ``2i + 1``)."""
    half = rope // 2
    idx = torch.arange(w.shape[1], device=w.device).reshape(-1, block)
    r = idx[:, block - rope:]
    pairs = torch.stack([r[:, :half], r[:, half:]], dim=-1).reshape(-1, rope)
    idx = torch.cat([idx[:, :block - rope], pairs], dim=1).reshape(-1)
    return w[:, idx]


def yarn_inv_freq(cfg: dict, device=None) -> torch.Tensor:
    """The rope dims' inverse frequencies, YaRN-scaled as ``rope_scaling``
    states: ``f / factor`` below the correction range, ``f`` above it,
    a linear blend inside it."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    i = torch.arange(dim // 2, dtype=F32, device=device)
    f = 1.0 / base ** (2 * i / dim)
    rs = cfg.get("rope_scaling")
    if not rs:
        return f
    factor = float(rs["factor"])
    original = rs["original_max_position_embeddings"]

    def slot(turns):
        return dim * math.log(original / (turns * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(slot(rs["beta_fast"])), 0)
    high = min(math.ceil(slot(rs["beta_slow"])), dim - 1)
    ramp = torch.clamp((i - low) / max(high - low, 0.001), 0, 1)
    m = 1 - ramp
    return f / factor * (1 - m) + f * m


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs:
        m = _mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale = scale * m * m
    return scale


def rope(x: torch.Tensor, inv_freq: torch.Tensor, cfg: dict,
         prec: Precision) -> torch.Tensor:
    """Rotate pairs ``(2i, 2i + 1)`` of ``x`` (S, ..., rope) by position
    times ``inv_freq[i]``; YaRN's ``mscale / mscale_all_dim`` on cos and
    sin (1 for the published values)."""
    s = x.shape[0]
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv_freq
    rs = cfg.get("rope_scaling")
    m = 1.0 if not rs else (_mscale(float(rs["factor"]), float(rs["mscale"]))
                            / _mscale(float(rs["factor"]),
                                      float(rs["mscale_all_dim"])))
    cos = (torch.cos(ang) * m).reshape(s, *[1] * (x.ndim - 2), -1)
    sin = (torch.sin(ang) * m).reshape(s, *[1] * (x.ndim - 2), -1)
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return prec.round(out.reshape(x.shape))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, cfg: dict,
            prec: Precision) -> torch.Tensor:
    y = prec.round(x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True)
                                   + cfg["rms_norm_eps"]))
    return prec.round(y * w.to(F32))


def linear(x: torch.Tensor, w: torch.Tensor, prec: Precision
           ) -> torch.Tensor:
    return prec.round(x @ w.to(F32))


def silu(x: torch.Tensor, prec: Precision) -> torch.Tensor:
    r = prec.round
    return r(x * r(1 / r(1 + r(torch.exp(-x)))))


def swiglu(x: torch.Tensor, gate, up, down, prec: Precision
           ) -> torch.Tensor:
    g, u = linear(x, gate, prec), linear(x, up, prec)
    return linear(prec.round(silu(g, prec) * u), down, prec)


def attention(lw: dict, x: torch.Tensor, cfg: dict, prec: Precision,
              heads_at_once: int = 32) -> torch.Tensor:
    """Causal MLA over one sequence ``x`` (S, d) -> (S, d)."""
    s = x.shape[0]
    h = cfg["num_attention_heads"]
    nope, rp, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                    cfg["v_head_dim"])
    inv_freq = yarn_inv_freq(cfg, x.device)
    q = linear(rmsnorm(linear(x, lw["q_a"], prec), lw["q_a_norm"], cfg, prec),
               lw["q_b"], prec).reshape(s, h, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], inv_freq, cfg, prec)],
                  dim=-1)
    kv = linear(x, lw["kv_a"], prec)
    c = rmsnorm(kv[:, :cfg["kv_lora_rank"]], lw["kv_a_norm"], cfg, prec)
    k_pe = rope(kv[:, cfg["kv_lora_rank"]:], inv_freq, cfg, prec)
    kvb = linear(c, lw["kv_b"], prec).reshape(s, h, nope + dv)
    k = torch.cat([kvb[..., :nope], k_pe[:, None, :].expand(s, h, rp)],
                  dim=-1)
    v = kvb[..., nope:]
    scale = softmax_scale(cfg)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    out = torch.empty((s, h, dv), dtype=F32, device=x.device)
    for h0 in range(0, h, heads_at_once):
        hs = slice(h0, h0 + heads_at_once)
        scores = prec.round_acc(torch.einsum("qhd,khd->hqk", q[:, hs],
                                             k[:, hs]) * scale)
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")),
                          dim=-1)
        out[:, hs] = prec.round(torch.einsum("hqk,khd->qhd", prec.round(p),
                                             v[:, hs]))
    return linear(out.reshape(s, h * dv), lw["o"], prec)


def route(lw: dict, x: torch.Tensor, cfg: dict, prec: Precision):
    """(ids (S, k), weights (S, k)): the auxiliary-loss-free router."""
    w_r = prec.round_acc(lw["router"].to(F32))
    logits = prec.round_acc(prec.round_acc(x) @ w_r)
    scores = torch.sigmoid(logits)
    choice = scores + lw["bias"].to(F32)
    s, e = choice.shape
    g = cfg["n_group"]
    grouped = choice.reshape(s, g, e // g)
    top2 = torch.sort(grouped, dim=-1, descending=True, stable=True).values
    group_score = top2[..., 0] + top2[..., 1]
    kept = torch.sort(group_score, dim=-1, descending=True,
                      stable=True).indices[:, :cfg["topk_group"]]
    allowed = torch.zeros((s, g), dtype=torch.bool, device=x.device)
    allowed[torch.arange(s, device=x.device)[:, None], kept] = True
    choice = choice.masked_fill(~allowed.repeat_interleave(e // g, dim=1),
                                float("-inf"))
    ids = torch.sort(choice, dim=-1, descending=True,
                     stable=True).indices[:, :cfg["num_experts_per_tok"]]
    w = scores.gather(1, ids)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    return ids, w * cfg["routed_scaling_factor"]


def moe(lw: dict, x: torch.Tensor, cfg: dict, prec: Precision,
        routes: list | None = None) -> torch.Tensor:
    """The held experts' weighted outputs, in ascending expert id, plus the
    shared expert; ``routes`` gains the ids."""
    ids, w = route(lw, x, cfg, prec)
    if routes is not None:
        routes.append(ids)
    lo = cfg.get("expert_offset", 0)
    y = torch.zeros_like(x)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == lo + j, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], lw["experts_gate"][j], lw["experts_up"][j],
                         lw["experts_down"][j], prec)
            y[tok] = prec.round(y[tok] + prec.round(
                out * prec.round(w[tok, slot][:, None])))
    return prec.round(y + swiglu(x, lw["shared_gate"], lw["shared_up"],
                                 lw["shared_down"], prec))


def embed(w: dict, tokens: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.round(w["embed"][tokens.long()].to(F32))


def layer(lw: dict, cfg: dict, index: int, h: torch.Tensor,
          prec: Precision, routes: list | None = None,
          taps: dict | None = None) -> torch.Tensor:
    """Layer ``index`` on the residual stream ``h`` (S, d); ``taps`` gains
    the attention's input and output (``"attn"``, a pair) and an MoE
    layer's router input (``"router"``)."""
    with no_tf32():
        x = rmsnorm(h, lw["attn_norm"], cfg, prec)
        a = attention(lw, x, cfg, prec)
        if taps is not None:
            taps["attn"].append((x, a))
        h = prec.round(h + a)
        x = rmsnorm(h, lw["ffn_norm"], cfg, prec)
        if index < cfg["first_k_dense_replace"]:
            y = swiglu(x, lw["gate"], lw["up"], lw["down"], prec)
        else:
            if taps is not None:
                taps["router"].append(x)
            y = moe(lw, x, cfg, prec, routes)
        return prec.round(h + y)


def final(w: dict, h: torch.Tensor, cfg: dict, prec: Precision
          ) -> torch.Tensor:
    """The last hidden state under the final norm (S, d)."""
    return rmsnorm(h, w["final_norm"], cfg, prec)


def features(w: dict, cfg: dict, tokens: torch.Tensor, prec: Precision,
             routes: list | None = None) -> torch.Tensor:
    """(d,) float32: the final-norm hidden state averaged over positions."""
    h = embed(w, tokens, prec)
    for i, lw in enumerate(w["layers"]):
        h = layer(lw, cfg, i, h, prec, routes)
    return final(w, h, cfg, prec).mean(dim=0)


def logits(w: dict, cfg: dict, tokens: torch.Tensor, prec: Precision,
           routes: list | None = None) -> torch.Tensor:
    """(S, V) next-token logits of every position."""
    h = embed(w, tokens, prec)
    for i, lw in enumerate(w["layers"]):
        h = layer(lw, cfg, i, h, prec, routes)
    with no_tf32():
        return linear(final(w, h, cfg, prec), w["unembed"], prec)
