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

The MoE layer (sort-based capacity dispatch, softmax or sigmoid router,
deepseek-v3's group-limited sigmoid router, optional shared expert, one
chip's share of the experts) and the Mamba2 SSD (`ssd_scan`, `ssd_step`,
`ssd_block`) follow the JAX package's arithmetic: the router product in
true f32 with a stable top-k, and the SSD's three-operand products
written out as the pairs XLA contracts, in f32 on the operands' rounded
values. The MLA attention lives in `repro_torch.models.lm`, as in the JAX
package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch import obs
from repro_torch.device import resolve


class MetaDraws:
    """A generator stand-in that draws nothing: ``*_init`` given one builds
    the parameters on the meta device, shapes and dtypes alone (the
    sharding rules read a full-width model's shapes this way)."""

    device = torch.device("meta")


def _normal(shape, generator: torch.Generator | MetaDraws) -> torch.Tensor:
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
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

class YaRN(NamedTuple):
    """YaRN rope scaling as deepseek-v3's config.json states it
    (``rope_scaling``: type yarn)."""

    factor: float
    original_max: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


def yarn_mscale(factor: float, mscale: float) -> float:
    """``0.1 * mscale * ln(factor) + 1`` (1 for no extension)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_ramp(head_dim: int, theta: float, y: YaRN) -> tuple[int, int]:
    """(low, high): the rotary slots whose wavelength lies between
    ``beta_fast`` and ``beta_slow`` turns over the original context,
    ``floor`` / ``ceil`` of ``D ln(L / (beta 2 pi)) / (2 ln theta)``,
    clamped to the slots."""
    def slot(turns):
        return head_dim * math.log(y.original_max / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))

    return (max(math.floor(slot(y.beta_fast)), 0),
            min(math.ceil(slot(y.beta_slow)), head_dim - 1))


def rope_freqs(head_dim: int, theta: float, *, device=None,
               yarn: YaRN | None = None) -> torch.Tensor:
    """The D/2 inverse frequencies ``theta ** (-2i / D)``; with ``yarn``,
    YaRN's blend ``f / factor * (1 - m) + f * m``, where ``m`` falls from
    1 to 0 linearly over the slots `yarn_ramp` names (interpolated below
    it, extrapolated above)."""
    device = resolve(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=device), exps)
    if yarn is None:
        return freqs
    low, high = yarn_ramp(head_dim, theta, yarn)
    span = high - low if high > low else 0.001
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low) / span, 0, 1)
    extra = 1.0 - ramp
    return freqs / yarn.factor * (1 - extra) + freqs * extra


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                yarn: YaRN | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (B, S, D/2), built once per step
    (`ArchConfig.precompute_rope`); YaRN scales both by ``mscale(factor,
    mscale) / mscale(factor, mscale_all_dim)`` (1 for deepseek-v3)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device, yarn=yarn)
    angles = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        m = (yarn_mscale(yarn.factor, yarn.mscale)
             / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        cos, sin = cos * m, sin * m
    return cos, sin


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               tables: tuple[torch.Tensor, torch.Tensor] | None = None,
               yarn: YaRN | None = None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integers."""
    if tables is None:
        tables = rope_tables(positions, x.shape[-1], theta, yarn)
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
                      window: int | None = None, q_offset=0,
                      scale: float | None = None) -> torch.Tensor:
    """Flash-style attention with O(S_q / chunk) temporaries (plain torch).

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H = KV * G; kv heads are
    repeated to full heads. Each q-chunk attends to all of k under the mask.
    Scores and the probability-weighted sum accumulate in f32 from the
    operands' own values (as the JAX package's ``preferred_element_type``);
    the probabilities are cast to v's dtype first and the output is in v's
    dtype. `window` adds sliding-window masking; `q_offset` positions q
    within the kv stream; ``scale`` multiplies the scores (``D ** -0.5``
    unless given). Fully masked rows give zeros, not NaN. One device:
    the JAX package's mesh constraint has no counterpart here.
    """
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]  # may differ from d (MLA: qk-dim 192, v-dim 128)
    g = h // kv
    scale = d ** -0.5 if scale is None else scale
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


@contextlib.contextmanager
def true_f32():
    """f32 products in full f32 on the card (no TF32) for everything run
    inside, as the JAX reference computes them on the CPU."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Mixture of Experts: sort-based capacity dispatch
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """``router.w`` (d, E) in f32 over all E experts; ``gate`` / ``up``
    (n, d, f) and ``down`` (n, f, d) in the model's dtype for the n
    experts this layer holds (all E, or one chip's share under expert
    parallelism: `moe`'s ``expert_offset`` names the first); an optional
    ``shared`` `MLP`; an optional ``bias`` (E,) f32, the score-correction
    bias of the group-limited router (``router_type="sigmoid_group"``)."""

    def __init__(self, router: Linear, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor, shared: MLP | None = None,
                 bias: torch.Tensor | None = None):
        super().__init__()
        self.router = router
        self.gate = nn.Parameter(gate, requires_grad=False)
        self.up = nn.Parameter(up, requires_grad=False)
        self.down = nn.Parameter(down, requires_grad=False)
        self.shared = shared
        self.bias = None if bias is None else nn.Parameter(
            bias, requires_grad=False)


@dataclasses.dataclass
class MoECounts:
    """What a caller's MoE layers routed to the experts they hold, read
    from the expert counts that dispatch copies to the host: rows computed
    and slots dropped past the capacity, summed over calls, and each
    call's rows an expert held (``calls``, one list a call)."""

    held_rows: int = 0
    dropped_slots: int = 0
    calls: list = dataclasses.field(default_factory=list)

    def add(self, counts: list, cap: int, lo: int, hi: int) -> None:
        """One call's ``counts`` (slots an expert, all E) at capacity
        ``cap``, of which experts ``[lo, hi)`` are held."""
        rows = [min(n, cap) for n in counts[lo:hi]]
        self.calls.append(rows)
        self.held_rows += sum(rows)
        self.dropped_slots += sum(counts[lo:hi]) - sum(rows)


def _normal_stack(n: int, shape, scale: float, dtype,
                  generator: torch.Generator) -> torch.Tensor:
    """``n`` normal slices times ``scale`` in ``dtype``, drawn one slice at
    a time (an f32 draw of a whole expert stack at deepseek-v3 width would
    be a 15 GB temporary)."""
    out = torch.empty((n, *shape), dtype=dtype, device=generator.device)
    if out.device.type == "meta":
        return out
    for i in range(n):
        out[i] = (_normal(shape, generator) * scale).to(dtype)
    return out


def moe_init(generator: torch.Generator, d: int, d_ff_expert: int,
             n_experts: int, n_shared: int, d_ff_shared: int,
             dtype=torch.bfloat16, *, n_held: int | None = None,
             bias: bool = False) -> MoE:
    """A router over ``n_experts`` and the stacks of the ``n_held`` experts
    this layer holds (all unless given); ``bias``: a zero score-correction
    bias."""
    scale_in, scale_out = d ** -0.5, d_ff_expert ** -0.5
    n_held = n_experts if n_held is None else n_held
    router = Linear(_normal((d, n_experts), generator) * scale_in)  # f32
    gate = _normal_stack(n_held, (d, d_ff_expert), scale_in, dtype,
                         generator)
    up = _normal_stack(n_held, (d, d_ff_expert), scale_in, dtype,
                       generator)
    down = _normal_stack(n_held, (d_ff_expert, d), scale_out, dtype,
                         generator)
    shared = mlp_init(generator, d, d_ff_shared * n_shared, dtype=dtype) \
        if n_shared > 0 else None
    b = torch.zeros((n_experts,), dtype=torch.float32,
                    device=generator.device) if bias else None
    return MoE(router, gate, up, down, shared, b)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``: ``exp(x - max) / sum`` (one division)."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


@true_f32()
def route(p: MoE, xf: torch.Tensor, top_k: int, router_type: str, *,
          n_group: int = 1, topk_group: int = 1, scale: float = 1.0):
    """Router of (T, d) tokens -> (logits (T, E) f32, scores (T, E), the
    renormalised top-k weights (T, K), expert ids (T, K) int64).

    The product is taken in true f32 on ``xf`` cast to f32; the top k come
    from a stable descending sort, so a tie goes to the lower expert id as
    in ``lax.top_k`` (`torch.topk` leaves the order of ties unspecified).
    ``"sigmoid_group"`` is deepseek-v3's (``noaux_tc``): the experts are
    chosen on the sigmoid scores plus ``p.bias`` within the ``topk_group``
    of ``n_group`` groups whose two best biased scores sum highest
    (`group_limited_top_k`), and weighted by their unbiased scores. The
    weights are renormalised, then times ``scale``."""
    logits = xf.to(torch.float32) @ p.router.w
    if router_type == "softmax":
        scores = _softmax(logits)
    elif router_type in ("sigmoid", "sigmoid_group"):  # deepseek-v3 style
        scores = 1 / (1 + torch.exp(-logits))
    else:
        raise ValueError(router_type)
    if router_type == "sigmoid_group":
        choice = scores if p.bias is None else scores + p.bias
        ids = group_limited_top_k(choice, top_k, n_group, topk_group)
        w = scores.gather(1, ids)
    else:
        w, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
        w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return logits, scores, w * scale, ids


def group_limited_top_k(choice: torch.Tensor, top_k: int, n_group: int,
                        topk_group: int) -> torch.Tensor:
    """(T, K) ids of the top k of ``choice`` (T, E) among the experts of
    the ``topk_group`` groups (of ``n_group`` equal, contiguous groups)
    whose two highest values sum highest; ties to the lower group and the
    lower id (stable sorts), the rest of the experts set to -inf."""
    t, e = choice.shape
    grouped = choice.reshape(t, n_group, e // n_group)
    best2 = torch.sort(grouped, dim=-1, descending=True,
                       stable=True).values[..., :2]
    group_score = best2[..., 0] + best2[..., 1]
    kept = torch.sort(group_score, dim=-1, descending=True,
                      stable=True).indices[:, :topk_group]
    mask = torch.zeros((t, n_group), dtype=torch.bool, device=choice.device)
    mask.scatter_(1, kept, True)
    masked = torch.where(mask.repeat_interleave(e // n_group, dim=1),
                         choice, float("-inf"))
    return torch.sort(masked, dim=-1, descending=True,
                      stable=True).indices[:, :top_k]


def capacity(t: int, top_k: int, n_experts: int,
             capacity_factor: float, dropless: bool = False) -> int:
    """Slots per expert: ``t`` (no slot can drop) when ``dropless`` or up
    to 4096 tokens, else the capacity-factor rule."""
    if dropless or t <= 4096:
        return t
    return max(int(-(-t * top_k // n_experts) * capacity_factor), top_k)


def dispatch(ids: torch.Tensor, n_experts: int, cap: int, offset=None):
    """Sort the (token, k) slots by expert id (stable) -> (sort_idx,
    sorted_ids, pos_in_seg, keep, counts): a slot is kept when its position
    in its expert's segment is below ``cap``. ``offset`` (E,) counts the
    slots that earlier data coordinates put in each segment (a global
    batch cut over a mesh): positions start there. Segments come from
    `torch.searchsorted` (deterministic on the card, as `bincount` is
    not)."""
    flat = ids.reshape(-1)
    sort_idx = torch.sort(flat, stable=True).indices
    sorted_ids = flat[sort_idx]
    experts = torch.arange(n_experts, device=ids.device)
    seg_start = torch.searchsorted(sorted_ids, experts)
    counts = torch.searchsorted(sorted_ids, experts, right=True) - seg_start
    pos = torch.arange(flat.numel(), device=ids.device) - seg_start[sorted_ids]
    if offset is not None:
        pos = pos + offset.to(pos.device)[sorted_ids]
    return sort_idx, sorted_ids, pos, pos < cap, counts


def _experts(gate, up, down, xf, w, ids, slots, cap: int, lo: int = 0,
             offset=None, host_counts: list | None = None) -> torch.Tensor:
    """The weighted outputs of experts ``[lo, lo + len(gate))`` for (T, d)
    tokens -> (T, d) in xf's dtype; ``gate`` / ``up`` / ``down`` hold those
    experts alone, ``slots`` is `dispatch` of ``ids`` at ``cap`` (and
    ``offset``), ``host_counts`` its expert counts already on the host
    (read here otherwise).

    Only experts that received a kept slot are computed, one product per
    occupied segment: each row of the JAX zero-padded (E, C, d) buffer goes
    through its expert on its own, so the rows are the same. The outputs
    are added back to their tokens each in ascending expert id (the order
    of the JAX scatter's slots); a slot of another expert adds zero."""
    t, d = xf.shape
    top_k = ids.shape[1]
    hi = lo + gate.shape[0]
    sort_idx, sorted_ids, _, keep, counts = slots
    keep = keep & (sorted_ids >= lo) & (sorted_ids < hi)
    token_of_slot = sort_idx // top_k
    out = torch.zeros((t * top_k, d), dtype=xf.dtype, device=xf.device)
    if xf.device.type == "meta":
        _modelled_experts(gate, up, down, xf, out, cap, len(counts))
    else:
        _routed_experts(gate, up, down, xf, token_of_slot, out, cap, lo,
                        counts.tolist() if host_counts is None
                        else host_counts, offset)
    flat_w = w.reshape(-1)[sort_idx].to(xf.dtype)
    contrib = torch.where(keep[:, None], out * flat_w[:, None], 0)
    # back to (token, k) order, each token's slots by ascending expert id
    by_slot = torch.empty_like(contrib)
    by_slot[sort_idx] = contrib
    order = torch.argsort(ids, dim=-1)
    by_slot = torch.gather(by_slot.reshape(t, top_k, d), 1,
                           order[..., None].expand(t, top_k, d))
    y = torch.zeros((t, d), dtype=xf.dtype, device=xf.device)
    for j in range(top_k):
        y = y + by_slot[:, j]
    return y


def _routed_experts(gate, up, down, xf, token_of_slot, out, cap: int,
                    lo: int, counts: list, offset) -> None:
    """`_experts`' products as routed: each occupied segment of experts
    ``[lo, lo + len(gate))`` through its expert, written into its rows of
    ``out`` (``counts``: the expert counts on the host, so never on the
    meta device)."""
    hi = lo + gate.shape[0]
    before = [0] * len(counts) if offset is None else offset.tolist()
    # views of the experts: under grad one backward for the whole stack (a
    # `stack` of the experts' gradients), where each `gate[ex]` would add a
    # zero-filled copy of the stack
    gate, up, down = gate.unbind(0), up.unbind(0), down.unbind(0)
    start = 0
    for ex, n in enumerate(counts):
        kept = min(n, max(cap - before[ex], 0))
        if kept and lo <= ex < hi:
            rows = xf[token_of_slot[start:start + kept]]
            h = silu(rows @ gate[ex - lo]) * (rows @ up[ex - lo])
            out[start:start + kept] = h @ down[ex - lo]
        start += n


def _modelled_experts(gate, up, down, xf, out, cap: int, n_experts: int
                      ) -> None:
    """`_experts`' products on the meta device, where the routing has no
    values to read: a model of routing, not a trace of it. The kept slots
    are ``min(T * top_k, E * cap)``, spread evenly, so each expert takes
    ``ceil(kept / E)`` rows, at most ``cap``; the experts here (a slice of
    the E when expert-parallel) run as one batched product a weight, so
    each expert's weights are read once. The dry run
    (`repro_torch.launch.dryrun`) counts its operations and bytes."""
    n_local, slots = gate.shape[0], out.shape[0]
    kept = min(slots, n_experts * cap)
    rows_each = min(-(-kept // n_experts), cap)
    m = n_local * rows_each
    n = min(m, slots)
    # the gather of the kept rows (which rows, the model cannot say)
    rows = xf[torch.zeros((m,), dtype=torch.int64, device=xf.device)]
    rows = rows.reshape(n_local, rows_each, -1)
    h = silu(torch.bmm(rows, gate)) * torch.bmm(rows, up)
    out[:n] = torch.bmm(h, down).reshape(n_local * rows_each, -1)[:n]


def _aux(p: MoE, logits, scores, counts, router_type: str,
         aux_coeff: float):
    """The load-balance loss (fraction dispatched x mean router
    probability, softmax probabilities for either router) over these
    tokens, ``counts`` their slots an expert; inside a mesh step also
    recorded for the global batch's
    (`repro_torch.distributed.context.DataShard`)."""
    from repro_torch.distributed import context

    t, e = logits.shape
    probs = scores if router_type == "softmax" else _softmax(logits)
    counts = counts.to(torch.float32)
    aux = aux_coeff * e * (counts / t * probs.mean(dim=0)).sum()
    shard = context.data_shard()
    if shard is not None and getattr(p, "layer", None) is not None:
        shard.moe[p.layer] = (counts, probs.sum(dim=0), aux_coeff)
    return aux


def _global_drops(p: MoE, t: int):
    """(tokens, offset) for the capacity and its drops: this call's own,
    or, inside a mesh step, the global batch's and the expert counts of
    the data coordinates before this one."""
    from repro_torch.distributed import context

    shard = context.data_shard()
    if shard is None or getattr(p, "layer", None) is None:
        return t, None
    return shard.tokens, shard.prefix.get(p.layer)


@true_f32()
def moe(p: MoE, x: torch.Tensor, *, top_k: int, router_type: str = "softmax",
        capacity_factor: float = 1.25, aux_coeff: float = 0.01,
        n_group: int = 1, topk_group: int = 1, routed_scale: float = 1.0,
        expert_offset: int = 0, dropless: bool = False,
        counts: MoECounts | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE layer. x: (B, S, d) -> (y, aux_loss), the JAX semantics.

    Slots are sorted by expert id over all the router's experts and the
    first ``cap`` of each expert's segment are kept (`capacity`; every one
    when ``dropless``), then go through their experts (`_experts`: a
    decode step reads only the experts its tokens chose). A layer holding
    one chip's share of the experts (``p.gate`` shorter than the router,
    the first ``expert_offset``) computes and adds only those: what the
    others would add is left out, as expert parallelism leaves it to
    their chips. ``aux`` uses softmax probabilities for either router.
    Inside a mesh step the capacity and its drops are the global batch's,
    as JAX's global function keeps them. ``n_group``, ``topk_group`` and
    ``routed_scale`` configure the ``"sigmoid_group"`` router (`route`).
    ``counts`` gains this call's held rows and drops (`MoECounts`)."""
    b, s, d = x.shape
    e = p.router.w.shape[1]
    t = b * s
    xf = x.reshape(t, d)
    group = {} if router_type != "sigmoid_group" else dict(
        n_group=n_group, topk_group=topk_group, scale=routed_scale)
    with obs.span("repro_torch.lm.moe.route"):
        logits, scores, w, ids = route(p, xf, top_k, router_type, **group)
    t_all, offset = _global_drops(p, t)
    cap = capacity(t_all, top_k, e, capacity_factor, dropless)
    with obs.span("repro_torch.lm.moe.dispatch"):
        slots = dispatch(ids, e, cap, offset)
        aux = _aux(p, logits, scores, slots[4], router_type, aux_coeff)
        host = None if xf.device.type == "meta" else slots[4].tolist()
    if counts is not None and offset is None and host is not None:
        counts.add(host, cap, expert_offset, expert_offset + p.gate.shape[0])
    with obs.span("repro_torch.lm.moe.experts"):
        y = _experts(p.gate, p.up, p.down, xf, w, ids, slots, cap,
                     lo=expert_offset, offset=offset, host_counts=host)
        if p.shared is not None:
            y = y + mlp(p.shared, xf)
    return y.reshape(b, s, d), aux


@true_f32()
def moe_shardmap(p: MoE, x: torch.Tensor, *, top_k: int,
                 router_type: str = "softmax", capacity_factor: float = 1.25,
                 aux_coeff: float = 0.01, n_group: int = 1,
                 topk_group: int = 1, routed_scale: float = 1.0,
                 expert_offset: int = 0, dropless: bool = False,
                 counts: MoECounts | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE, the JAX package's ``shard_map`` form, with
    `moe`'s router options.

    With no mesh installed it is `moe`. Under one, each (dp, model) rank
    routes its dp-local tokens (activations are replicated over "model",
    so dispatch moves nothing), packs only its ``E / model`` experts with
    the capacity of ``T / dp`` tokens, and the combine sums the ranks'
    outputs over "model" in the activation dtype, rank 0 first (JAX's
    ``psum``). Rank (i, j) computes on its own device. Router, shared
    expert and the load-balance loss stay outside, as in JAX.

    Inside a mesh step the tokens here are one data coordinate's block;
    called on a whole batch under an installed mesh, they are cut into
    the dp blocks here. A layer that holds one chip's share of the experts
    has no share left to cut over "model": under a mesh it raises, as do
    ``counts``, which a mesh's cut rows would not fill as `moe` does."""
    from repro_torch.distributed import context, sharding

    ax, mesh = context.get(), context.get_mesh()
    if ax is None or mesh is None:
        return moe(p, x, top_k=top_k, router_type=router_type,
                   capacity_factor=capacity_factor, aux_coeff=aux_coeff,
                   n_group=n_group, topk_group=topk_group,
                   routed_scale=routed_scale, expert_offset=expert_offset,
                   dropless=dropless, counts=counts)
    b, s, d = x.shape
    e = p.router.w.shape[1]
    if p.gate.shape[0] != e or counts is not None:
        raise ValueError("moe_shardmap under a mesh cuts all the router's "
                         f"{e} experts over 'model': a layer holding "
                         f"{p.gate.shape[0]} of them, or MoE counters, "
                         "need `moe`")
    t = b * s
    xf = x.reshape(t, d)
    group = {} if router_type != "sigmoid_group" else dict(
        n_group=n_group, topk_group=topk_group, scale=routed_scale)
    logits, scores, w, ids = route(p, xf, top_k, router_type, **group)
    aux = _aux(p, logits, scores, dispatch(ids, e, t)[4], router_type,
               aux_coeff)
    ranks = mesh.ranks(ax.dp, ax.model)
    dp_size, mp_size = len(ranks), len(ranks[0])
    e_loc = e // mp_size
    shard = context.data_shard()
    if shard is not None:
        t_loc = max(shard.tokens // dp_size, 1)
        blocks = [(shard.index, slice(0, t))]
    else:
        t_loc = max(t // dp_size, 1)
        if t % dp_size:
            raise ValueError(f"{t} tokens do not cut into {dp_size} "
                             "data-parallel blocks")
        blocks = [(i, slice(i * t_loc, (i + 1) * t_loc))
                  for i in range(dp_size)]
    cap = capacity(t_loc, top_k, e, capacity_factor, dropless)
    parts = []
    for i, rows in blocks:
        home = xf.device
        y = None
        for j in range(mp_size):
            dev = mesh.devices[ranks[i][j]]
            ex = slice(j * e_loc, (j + 1) * e_loc)
            ids_j = ids[rows].to(dev)
            y_j = _experts(p.gate[ex].to(dev), p.up[ex].to(dev),
                           p.down[ex].to(dev), xf[rows].to(dev),
                           w[rows].to(dev), ids_j, dispatch(ids_j, e, cap),
                           cap, lo=j * e_loc).to(home)
            if j:  # the combine's psum over "model", into rank 0
                sharding.record_collective(
                    "all-reduce", y_j.numel() * y_j.element_size(),
                    ranks[i][0])
            y = y_j if y is None else y + y_j
        parts.append(y)
    y = torch.cat(parts) if len(parts) > 1 else parts[0]
    y = y.reshape(b, s, d)
    if p.shared is not None:
        y = y + mlp(p.shared, x)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality, chunked)
# ---------------------------------------------------------------------------

class SSMSpec(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    conv_kernel: int = 4
    chunk: int = 256


class SSD(nn.Module):
    """A Mamba2 block's parameters: ``in_proj`` -> [z, x, B, C, dt],
    ``conv_w`` (K, d_inner + 2N), ``A_log`` / ``D`` / ``dt_bias`` (H,) in
    f32, ``out_norm`` and ``out_proj``."""

    def __init__(self, in_proj: Linear, conv_w: torch.Tensor,
                 A_log: torch.Tensor, D: torch.Tensor, dt_bias: torch.Tensor,
                 out_norm: RMSNorm, out_proj: Linear):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        self.out_norm = out_norm
        self.conv_w = nn.Parameter(conv_w, requires_grad=False)
        self.A_log = nn.Parameter(A_log, requires_grad=False)
        self.D = nn.Parameter(D, requires_grad=False)
        self.dt_bias = nn.Parameter(dt_bias, requires_grad=False)


def ssd_init(generator: torch.Generator, d: int, spec: SSMSpec,
             dtype=torch.bfloat16) -> SSD:
    din, h, dev = spec.d_inner, spec.n_heads, generator.device
    d_proj = 2 * din + 2 * spec.d_state + h
    in_proj = linear_init(generator, d, d_proj, dtype=dtype)
    conv_w = (_normal((spec.conv_kernel, din + 2 * spec.d_state), generator)
              * 0.1).to(dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    return SSD(in_proj, conv_w, torch.zeros((h,), **f32),
               torch.ones((h,), **f32), torch.zeros((h,), **f32),
               rmsnorm_init(din, device=dev),
               linear_init(generator, din, d, dtype=dtype))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C). Returns (y,
    new_state), the state carrying the trailing K-1 inputs for decode.
    Each product and each running sum rounds to x's dtype, in the JAX
    order (tap 0 first)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = 0
    for i in range(k):
        y = y + xp[:, i:i + s, :] * w[i][None, None, :]
    new_state = xp[:, -(k - 1):, :] if k > 1 else x[:, :0]
    return y, new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """'Segment sum' in the cumsum-difference form: out[..., i, j] =
    cs[i] - cs[j] (the sum of a[j+1..i]) for j <= i, -inf above."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def y_off_order(d_state: int, head_dim: int) -> str:
    """Which pair of the inter-chunk output's three-operand product XLA
    contracts first (``jnp.einsum``'s cost-based path): the state with C
    (a sum over N) when N > P (mamba2-2.7b: N 128, P 64), else the decay
    with C (an exact product; the SMOKE configs and hymba-1.5b)."""
    return "states_c" if d_state > head_dim else "decay_c"


@true_f32()
def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, spec: SSMSpec,
             init_state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2 alg. 1 dual form).

    xh: (B, S, H, P); dt: (B, S, H) positive steps; A: (H,) negative
    rates; Bm, Cm: (B, S, N) (one group). Returns (y (B, S, H, P) in xh's
    dtype, final state (B, H, P, N) f32). S pads up to a multiple of the
    chunk. Each three-operand product of the JAX package is the pair of
    products XLA contracts, in f32 on operands rounded to xh's dtype:
    (decay-matrix x scores) then x xdt; (decay x xdt) then x B; and for
    the inter-chunk output the pair `y_off_order` names."""
    f32, dt_x = torch.float32, xh.dtype
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    L = spec.chunk
    nc = -(-s // L)
    pad = nc * L - s
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    xc = xh.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = Bm.reshape(b, nc, L, n)
    Cc = Cm.reshape(b, nc, L, n)

    def rounded(x):  # an operand cast to xh's dtype, read in f32
        return x.to(dt_x).to(f32)

    a = (dtc * A[None, None, None, :]).to(f32)  # (b, nc, L, h)
    a_hp = a.transpose(-1, -2)  # (b, nc, h, L)
    a_cum = torch.cumsum(a_hp, dim=-1)
    xdt_b = rounded(xc.to(f32) * dtc[..., None])  # (b, nc, L, h, p)

    # 1) intra-chunk (diagonal) term
    lmat = torch.exp(_segsum(a_hp))  # (b, nc, h, L, L)
    lmat = torch.where(torch.isfinite(lmat), lmat, 0.0)
    scores = torch.einsum("bcln,bcmn->bclm", Cc.to(f32), Bc.to(f32))
    pair = rounded(lmat) * rounded(scores)[:, :, None]  # (b,nc,h,L,L)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", pair, xdt_b)

    # 2) chunk states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (b, nc, h, L)
    pair = rounded(decay_states).transpose(-1, -2)[..., None] * xdt_b
    states = torch.einsum("bclhp,bcln->bchpn", pair, rounded(Bc))

    # 3) inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(a_cum[..., -1])  # (b, nc, h)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = rounded(torch.stack(prev, dim=1))  # (b, nc, h, p, n)

    # 4) inter-chunk output
    decay_out = rounded(torch.exp(a_cum))  # (b, nc, h, L)
    if y_off_order(n, p) == "states_c":
        pair = torch.einsum("bchpn,bcln->bchpl", prev_states, rounded(Cc))
        y_off = (pair * decay_out[:, :, :, None, :]).permute(0, 1, 4, 2, 3)
    else:  # (b, nc, L, h, n)
        pair = (decay_out.transpose(-1, -2)[..., None]
                * rounded(Cc)[:, :, :, None, :])
        y_off = torch.einsum("bclhn,bchpn->bclhp", pair, prev_states)

    y = (y_diag + y_off).reshape(b, nc * L, h, p)[:, :s]
    return y.to(dt_x), carry


@true_f32()
def ssd_step(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update (the decode path, no chunking).

    xh: (B, 1, H, P); dt: (B, 1, H); Bm, Cm: (B, 1, N); state (B, H, P, N)
    in f32: state' = state * exp(A dt) + (dt x) outer B; y = <state', C>.
    """
    f32 = torch.float32
    a = torch.exp(dt[:, 0, :, None, None].to(f32) * A[None, :, None, None])
    xdt = xh[:, 0].to(f32) * dt[:, 0, :, None].to(f32)  # (B, H, P)
    upd = xdt[..., None] * Bm[:, 0].to(f32)[:, None, None, :]
    new_state = state.to(f32) * a + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm[:, 0].to(f32))
    return y[:, None].to(xh.dtype), new_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def ssd_block(p: SSD, x: torch.Tensor, spec: SSMSpec, *,
              state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """The full Mamba2 block. x: (B, S, d). ``state``: None (a sequence
    from zero) or {"conv": (B, K-1, C), "ssm": (B, H, P, N)}. One token with
    a state takes `ssd_step`, anything else `ssd_scan`. Returns (y (B, S,
    d), {"conv", "ssm"})."""
    din, h, pd, n = spec.d_inner, spec.n_heads, spec.head_dim, spec.d_state
    proj = linear(p.in_proj, x)
    z, xin, Bm, Cm, dt = torch.split(proj, [din, din, n, n, h], dim=-1)
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p.conv_w, None if state is None else state["conv"])
    xin, Bm, Cm = torch.split(silu(conv_out), [din, n, n], dim=-1)

    dt = softplus(dt.to(torch.float32) + p.dt_bias)  # (B, S, H)
    A = -torch.exp(p.A_log)  # (H,) negative
    xh = xin.reshape(*xin.shape[:-1], h, pd)
    init = None if state is None else state["ssm"]
    if x.shape[1] == 1 and state is not None:
        y, final = ssd_step(xh, dt, A, Bm, Cm, init)
    else:
        y, final = ssd_scan(xh, dt, A, Bm, Cm, spec, init_state=init)
    y = y + (xh.to(torch.float32).to(y.dtype)
             * p.D.to(y.dtype)[None, None, :, None])
    y = y.reshape(*x.shape[:-1], din)
    y = rmsnorm(p.out_norm, y * silu(z))
    return linear(p.out_proj, y), {"conv": new_conv, "ssm": final}
