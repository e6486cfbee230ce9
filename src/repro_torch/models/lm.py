"""The LM zoo, in PyTorch: all ten of the JAX package's architectures,
served and trained.

One config dataclass and one model covering dense GQA transformers (llama /
qwen, optional QKV bias and qk-norm), MoE (phi3.5 softmax top-2; deepseek-v3
sigmoid top-8 with a shared expert and MLA, and as published: its leading
dense layers, group-limited router with a score-correction bias, YaRN, and
one chip's share of the experts), VLM backbones (M-RoPE,
embeddings as input), hybrid attention + SSM heads (hymba), encoder-only
backbones (hubert) and the pure SSM (mamba2's SSD).
``head_pad_multiple > 0`` pads the attention heads to a multiple of the
tensor-parallel degree, as the JAX package does (`padded_heads`): the
unpadded q, k, v and o are drawn and then re-laid, duplicated kv heads and
dead q slots with zero weights, so the padded model computes the unpadded
one's function.

The model is an `LM` module: ``embed`` (V, d) for token inputs, ``unembed``
(a `layers.Linear`), ``final_norm`` and ``layers``, an `nn.ModuleList` of
`Layer`s. Every parameter carries the JAX leaf name and layout, so the JAX
pytree (layers stacked on axis 0) maps onto it name by name
(`repro_torch.convert.lm_params_from_numpy`).

Entry points (the JAX package's names):
    init_params(key, cfg, device=None)        -> LM
    forward(params, cfg, tokens/embeds)       -> (logits, aux)
    features(params, cfg, tokens)             -> (B, d) pooled final-norm
    loss_fn(params, cfg, batch)               -> scalar loss
    prefill(params, cfg, inputs, max_len=...) -> (last logits, Cache)
    decode_step(params, cfg, tokens, cache)   -> (logits (B, 1, V), Cache)

`Cache` keeps the JAX contract: every tensor field batches at axis 1, with
one shared ``length`` (a Python int here: the port runs eagerly).
`decode_step` writes the new token's state into the cache's tensors in
place and returns the cache with ``length + 1``. MLA prefills with the
expanded attention and decodes with the weight-absorbed one over the
compressed cache, as the JAX package does (the two differ by rounding).
The expanded attention's core is one launch of the MLA prefill kernel
(`kernels/mla_prefill`) on the card in bf16 without grad at DeepSeek-V2/
V3's head widths, and `layers.chunked_attention` everywhere else.
Every f32 product runs in true f32 on the card (`layers.true_f32`).

`forward` and `loss_fn` are differentiable: with grad mode on and the
parameters requiring grad (`init_params` returns them frozen, for
serving; the trainer, `repro_torch.launch.steps`, turns every leaf on, as
JAX differentiates every leaf of its tree), ``cfg.remat`` recomputes each
layer in the backward (`torch.utils.checkpoint`, the JAX package's
``jax.checkpoint`` around its layer scan). Recomputation runs outside
`forward`'s own `true_f32`, so a caller on the card takes the backward
under `layers.true_f32` too. `prefill` and `decode_step` never build a
graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.device import resolve
from repro_torch.distributed import context as mesh_ctx
from repro_torch.kernels.mla_prefill import mla_prefill
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    sliding_window: int | None = None  # hymba long-context attention
    rope: str = "standard"  # standard | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    # inputs
    input_mode: str = "tokens"  # tokens | embeds (vlm/audio stubs)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    router_type: str = "softmax"  # softmax | sigmoid | sigmoid_group
    capacity_factor: float = 1.25
    # deepseek-v3 as published (every default leaves a model as it was)
    first_k_dense: int = 0  # leading layers with a dense MLP of d_ff
    n_group: int = 1  # sigmoid_group: expert groups, and the groups kept
    topk_group: int = 1
    router_bias: bool = False  # sigmoid_group: a score-correction bias
    routed_scaling_factor: float = 1.0
    #: the experts this chip holds of each MoE layer (0: all n_experts),
    #: from ``expert_offset``; the router still spans all of them
    experts_held: int = 0
    expert_offset: int = 0
    dropless: bool = False  # no routed slot dropped at any token count
    yarn: L.YaRN | None = None  # rope scaling of the (MLA rope) dims
    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM
    ssm: bool = False  # attention-free (mamba2)
    hybrid: bool = False  # parallel attn + ssm heads (hymba)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # numerics / misc
    dtype: Any = torch.bfloat16
    remat: bool = True
    q_chunk: int = 512
    # performance options of the JAX package
    precompute_rope: bool = False  # hoist cos/sin tables out of the layers
    moe_impl: str = "gspmd"  # "gspmd" | "shard_map" (manual EP collectives)
    #: pad attention heads to a multiple of the tensor-parallel degree
    head_pad_multiple: int = 0

    @property
    def uses_attention(self) -> bool:
        return not self.ssm

    @property
    def n_held(self) -> int:
        """Experts drawn and computed per MoE layer."""
        return self.experts_held or self.n_experts

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense if self.n_experts else 0

    @property
    def softmax_scale(self) -> float:
        """MLA's score scale: ``(nope + rope) ** -0.5``, times YaRN's
        ``mscale(factor, mscale_all_dim) ** 2``."""
        scale = (self.qk_nope_dim + self.qk_rope_dim) ** -0.5
        if self.yarn is not None:
            m = L.yarn_mscale(self.yarn.factor, self.yarn.mscale_all_dim)
            scale = scale * m * m
        return scale

    @property
    def ssm_spec(self) -> L.SSMSpec:
        d_inner = self.ssm_expand * self.d_model if self.ssm else self.d_model
        return L.SSMSpec(
            d_inner=d_inner,
            n_heads=d_inner // self.ssm_headdim,
            head_dim=self.ssm_headdim,
            d_state=self.ssm_state,
            chunk=self.ssm_chunk,
        )

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and reporting): the
        experts held here, the router and its bias over all of them, the
        leading dense layers' MLPs; norms not counted."""
        d, hd = self.d_model, self.head_dim
        n = 0
        if self.input_mode == "tokens":
            n += self.vocab * d
        n += self.vocab * d  # unembed
        per = 0
        if self.mla:
            per += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim)
            per += d * (self.kv_lora_rank + self.qk_rope_dim)
            per += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim
                                                       + self.v_head_dim)
            per += self.n_heads * self.v_head_dim * d
        elif self.ssm:
            spec = self.ssm_spec
            per += d * (2 * spec.d_inner + 2 * spec.d_state + spec.n_heads)
            per += spec.d_inner * d
        else:
            per += d * self.n_heads * hd  # q
            per += 2 * d * self.n_kv_heads * hd  # k, v
            per += self.n_heads * hd * d  # o
            if self.hybrid:
                spec = self.ssm_spec
                per += d * (2 * spec.d_inner + 2 * spec.d_state
                            + spec.n_heads)
                per += spec.d_inner * d
        if self.n_experts == 0:
            if self.d_ff > 0:
                per += 3 * d * self.d_ff
            return n + self.n_layers * per
        moe = d * self.n_experts  # router
        moe += self.n_experts if self.router_bias else 0
        moe += self.n_held * 3 * d * self.d_ff_expert
        moe += self.n_shared_experts * 3 * d * self.d_ff_expert
        return (n + self.n_layers * per + self.n_moe_layers * moe
                + self.first_k_dense * 3 * d * self.d_ff)

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k), for 6*N_active*D: the
        held experts a token does not reach taken off. A config without
        leading dense layers, as the JAX package has them all, keeps its
        count, which takes the shared experts off as well (the registry
        holds the two packages' counts equal)."""
        if self.n_experts == 0:
            return self.param_count()
        idle = self.n_held - min(self.top_k, self.n_held)
        if not self.first_k_dense:
            idle -= self.n_shared_experts
        return self.param_count() - self.n_moe_layers * idle * 3 \
            * self.d_model * self.d_ff_expert


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, q: L.Linear, k: L.Linear, v: L.Linear, o: L.Linear,
                 q_norm: L.RMSNorm | None = None,
                 k_norm: L.RMSNorm | None = None):
        super().__init__()
        self.q, self.k, self.v, self.o = q, k, v, o
        self.q_norm, self.k_norm = q_norm, k_norm


class MLA(nn.Module):
    """deepseek's multi-head latent attention: a low-rank query
    (``q_a`` -> ``q_a_norm`` -> ``q_b``), a compressed kv (``kv_a`` ->
    ``kv_a_norm``, with the shared rope key) expanded by ``kv_b``, and
    ``o``."""

    def __init__(self, q_a: L.Linear, q_a_norm: L.RMSNorm, q_b: L.Linear,
                 kv_a: L.Linear, kv_a_norm: L.RMSNorm, kv_b: L.Linear,
                 o: L.Linear):
        super().__init__()
        self.q_a, self.q_a_norm, self.q_b = q_a, q_a_norm, q_b
        self.kv_a, self.kv_a_norm, self.kv_b = kv_a, kv_a_norm, kv_b
        self.o = o


class Layer(nn.Module):
    """``ln1``, then ``attn`` (`Attention` or `MLA`; None for mamba2), the
    ``ssd`` block of the SSM and hybrid families with hymba's
    ``attn_out_norm`` / ``ssm_out_norm``, then ``ln2`` and ``mlp`` or
    ``moe`` (neither for mamba2)."""

    def __init__(self, ln1: L.RMSNorm, attn: nn.Module | None,
                 ln2: L.RMSNorm | None, mlp: L.MLP | None, *,
                 moe: L.MoE | None = None, ssd: L.SSD | None = None,
                 attn_out_norm: L.RMSNorm | None = None,
                 ssm_out_norm: L.RMSNorm | None = None):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp
        self.moe, self.ssd = moe, ssd
        self.attn_out_norm, self.ssm_out_norm = attn_out_norm, ssm_out_norm


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor | None, unembed: L.Linear,
                 final_norm: L.RMSNorm, layers: list[Layer]):
        super().__init__()
        self.embed = None if embed is None else nn.Parameter(
            embed, requires_grad=False)
        self.unembed, self.final_norm = unembed, final_norm
        self.layers = nn.ModuleList(layers)


# ---------------------------------------------------------------------------
# head padding: the JAX package's mesh-aligned head layout
# ---------------------------------------------------------------------------

def _pad_geom(cfg: ArchConfig):
    """Mesh-aligned head geometry (hp, kvp, dup, gp), or None.

    The kv heads pad to ``kvp = m`` by duplication (which needs KV | m, or
    g == 1, where plain dead heads do); the q heads pad to ``hp = kvp *
    gp`` with ``gp = ceil(g / dup)``. Padded q slot s belongs to padded
    group s // gp; its original head is ``g * ((s // gp) // dup) + ((s //
    gp) % dup) * gp + s % gp``, valid while that offset in its group is
    below g."""
    m = cfg.head_pad_multiple
    if m <= 0:
        return None
    H, KV = cfg.n_heads, cfg.n_kv_heads
    g = H // KV
    if KV % m == 0 and H % m == 0:
        return None  # already aligned
    if g == 1:
        hp = -(-H // m) * m
        return (hp, hp, 1, 1)
    if m % KV != 0:
        return None  # unsupported geometry (e.g. hymba's kv 5)
    kvp = m
    dup = kvp // KV
    gp = -(-g // dup)
    return (kvp * gp, kvp, dup, gp)


def _q_head_map(cfg: ArchConfig) -> tuple[list[int], list[bool]]:
    """(original head, valid) for each slot of the padded q layout."""
    hp, kvp, dup, gp = _pad_geom(cfg)
    H, KV = cfg.n_heads, cfg.n_kv_heads
    g = H // KV if KV else 1
    idx, valid = [], []
    for s_ in range(hp):
        grp, t = s_ // gp, s_ % gp
        if dup == 1:  # MHA dead-head padding
            o = s_
            ok = o < H
        else:
            o = g * (grp // dup) + (grp % dup) * gp + t
            ok = ((grp % dup) * gp + t) < g and (grp // dup) < KV
        idx.append(o if ok else 0)
        valid.append(ok)
    return idx, valid


def _relay(x: torch.Tensor, heads: int, axis: int, idx, valid
           ) -> torch.Tensor:
    """The heads of ``x`` (``heads * hd`` along ``axis``) picked by
    ``idx``, the invalid ones zeroed, in x's dtype."""
    shape = list(x.shape)
    hd = shape[axis] // heads
    xh = x.reshape(*shape[:axis], heads, hd, *shape[axis + 1:])
    index = torch.as_tensor(idx, device=x.device)
    mask = torch.as_tensor(valid, dtype=x.dtype, device=x.device).reshape(
        [-1] + [1] * (xh.ndim - axis - 1))
    out = xh.index_select(axis, index) * mask
    return out.reshape(*shape[:axis], len(idx) * hd, *shape[axis + 1:])


def pad_q(p: L.Linear, cfg: ArchConfig, axis: int) -> L.Linear:
    """A q-side linear re-laid into the padded head layout (dead slots
    zero): ``w`` (d, H*hd) on axis 1 (q), or (H*hd, d) on axis 0 (o); a
    bias follows the head axis (q only)."""
    idx, valid = _q_head_map(cfg)
    w = _relay(p.w.data, cfg.n_heads, axis, idx, valid)
    b = None if p.b is None else _relay(p.b.data, cfg.n_heads, 0, idx, valid)
    return L.Linear(w, b)


def pad_kv(p: L.Linear, cfg: ArchConfig) -> L.Linear:
    """A k or v linear with its kv-head columns duplicated into the padded
    layout."""
    hp, kvp, dup, gp = _pad_geom(cfg)
    KV = cfg.n_kv_heads
    idx = [min(i // max(dup, 1), KV - 1) for i in range(kvp)]
    valid = [i < KV * max(dup, 1) if dup > 1 else i < KV
             for i in range(kvp)]
    w = _relay(p.w.data, KV, 1, idx, valid)
    b = None if p.b is None else _relay(p.b.data, KV, 0, idx, valid)
    return L.Linear(w, b)


def padded_heads(cfg: ArchConfig) -> tuple[int, int]:
    """(q heads, kv heads) as laid out: padded when `head_pad_multiple`
    asks for it."""
    geom = _pad_geom(cfg)
    if geom is None:
        return cfg.n_heads, cfg.n_kv_heads
    return geom[0], geom[1]


def _init_attn(g: torch.Generator, cfg: ArchConfig) -> Attention:
    """The unpadded q, k, v and o drawn in order, then re-laid into the
    padded head layout when `head_pad_multiple` asks for one."""
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = L.linear_init(g, d, H * hd, bias=cfg.qkv_bias, dtype=dt)
    k = L.linear_init(g, d, KV * hd, bias=cfg.qkv_bias, dtype=dt)
    v = L.linear_init(g, d, KV * hd, bias=cfg.qkv_bias, dtype=dt)
    o = L.linear_init(g, H * hd, d, dtype=dt)
    if _pad_geom(cfg) is not None:
        q, k, v, o = (pad_q(q, cfg, 1), pad_kv(k, cfg), pad_kv(v, cfg),
                      pad_q(o, cfg, 0))
    if not cfg.qk_norm:
        return Attention(q, k, v, o)
    return Attention(q, k, v, o, L.rmsnorm_init(hd, device=g.device),
                     L.rmsnorm_init(hd, device=g.device))


def _init_mla(g: torch.Generator, cfg: ArchConfig) -> MLA:
    d, dt, dev = cfg.d_model, cfg.dtype, g.device
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return MLA(
        L.linear_init(g, d, cfg.q_lora_rank, dtype=dt),
        L.rmsnorm_init(cfg.q_lora_rank, device=dev),
        L.linear_init(g, cfg.q_lora_rank, cfg.n_heads * qk_dim, dtype=dt),
        L.linear_init(g, d, cfg.kv_lora_rank + cfg.qk_rope_dim, dtype=dt),
        L.rmsnorm_init(cfg.kv_lora_rank, device=dev),
        L.linear_init(g, cfg.kv_lora_rank,
                      cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                      dtype=dt),
        L.linear_init(g, cfg.n_heads * cfg.v_head_dim, d, dtype=dt))


def _init_layer(g: torch.Generator, cfg: ArchConfig, index: int) -> Layer:
    """Layer ``index``: an MoE layer past the ``first_k_dense`` leading
    dense ones when the config has experts."""
    d, dev = cfg.d_model, g.device
    ln1 = L.rmsnorm_init(d, device=dev)
    if cfg.ssm:  # mamba2: a pure SSM stack, no separate MLP
        return Layer(ln1, None, None, None,
                     ssd=L.ssd_init(g, d, cfg.ssm_spec, dtype=cfg.dtype))
    attn = _init_mla(g, cfg) if cfg.mla else _init_attn(g, cfg)
    hybrid = {}
    if cfg.hybrid:
        hybrid = dict(ssd=L.ssd_init(g, d, cfg.ssm_spec, dtype=cfg.dtype),
                      attn_out_norm=L.rmsnorm_init(d, device=dev),
                      ssm_out_norm=L.rmsnorm_init(d, device=dev))
    ln2 = L.rmsnorm_init(d, device=dev)
    if cfg.n_experts > 0 and index >= cfg.first_k_dense:
        return Layer(ln1, attn, ln2, None, **hybrid, moe=L.moe_init(
            g, d, cfg.d_ff_expert, cfg.n_experts, cfg.n_shared_experts,
            cfg.d_ff_expert, dtype=cfg.dtype, n_held=cfg.n_held,
            bias=cfg.router_bias))
    return Layer(ln1, attn, ln2, L.mlp_init(g, d, cfg.d_ff, dtype=cfg.dtype),
                 **hybrid)


def init_params(key: int | torch.Generator, cfg: ArchConfig, *,
                device=None) -> LM:
    """Random weights in the JAX package's distributions (normal times
    ``din ** -0.5``, the embedding normal times 0.02, the SSD's conv
    normal times 0.1), drawn in order from ``key`` (a seed, or a generator
    on the target device) on ``device`` (the card unless the caller asks
    for the CPU). ``device="meta"`` draws nothing: the model's shapes and
    dtypes alone, at any width."""
    if isinstance(key, torch.Generator):
        g = key
    elif resolve(device).type == "meta":
        g = L.MetaDraws()
    else:
        g = torch.Generator(device=resolve(device)).manual_seed(int(key))
    embed = None
    if cfg.input_mode == "tokens":
        embed = (L._normal((cfg.vocab, cfg.d_model), g) * 0.02).to(cfg.dtype)
    unembed = L.linear_init(g, cfg.d_model, cfg.vocab, dtype=cfg.dtype)
    layers = [_init_layer(g, cfg, i) for i in range(cfg.n_layers)]
    return LM(embed, unembed, L.rmsnorm_init(cfg.d_model, device=g.device),
              layers).eval()


# ---------------------------------------------------------------------------
# layer application (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def _rope(cfg: ArchConfig, x, positions, tables=None):
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        return L.apply_mrope(x, positions, cfg.rope_theta,
                             cfg.mrope_sections)
    return L.apply_rope(x, positions, cfg.rope_theta, tables=tables,
                        yarn=cfg.yarn)


def _rope_tables(cfg: ArchConfig, positions):
    """Step-level rope tables (`precompute_rope`), built once."""
    if not cfg.precompute_rope or cfg.rope != "standard":
        return None
    d = cfg.qk_rope_dim if cfg.mla else cfg.head_dim
    return L.rope_tables(positions, d, cfg.rope_theta, cfg.yarn)


def _attn_qkv(p: Attention, cfg: ArchConfig, h, positions, tables=None):
    b, s, _ = h.shape
    H, KV = padded_heads(cfg)
    q = L.linear(p.q, h).reshape(b, s, H, cfg.head_dim)
    k = L.linear(p.k, h).reshape(b, s, KV, cfg.head_dim)
    v = L.linear(p.v, h).reshape(b, s, KV, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(p.q_norm, q)
        k = L.rmsnorm(p.k_norm, k)
    return _rope(cfg, q, positions, tables), _rope(cfg, k, positions,
                                                   tables), v


def _mla_q(p: MLA, cfg: ArchConfig, h, positions, tables=None):
    """-> (q_nope (B, S, H, nope), q_rope (B, S, H, rope))."""
    b, s, _ = h.shape
    qa = L.rmsnorm(p.q_a_norm, L.linear(p.q_a, h))
    q = L.linear(p.q_b, qa).reshape(
        b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                 dim=-1)
    return q_nope, _rope(cfg, q_rope, positions, tables)


def _mla_kv_compressed(p: MLA, cfg: ArchConfig, h, positions, tables=None):
    """-> (c_kv (B, S, kv_lora), k_rope (B, S, rope)): what MLA caches."""
    c_kv, k_rope = torch.split(L.linear(p.kv_a, h),
                               [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    c_kv = L.rmsnorm(p.kv_a_norm, c_kv)
    k_rope = _rope(cfg, k_rope[:, :, None, :], positions, tables)[:, :, 0]
    return c_kv, k_rope


def _mla_prefill_kernel(cfg: ArchConfig, q_nope: torch.Tensor) -> bool:
    """Whether `_mla_train_attention` takes the MLA prefill kernel: bf16 on
    the card, no grad (it has no backward), causal, and DeepSeek-V2/V3's
    published head widths. Else `chunked_attention`."""
    return (q_nope.is_cuda and q_nope.dtype == torch.bfloat16
            and not torch.is_grad_enabled() and cfg.causal
            and (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim)
            == mla_prefill.WIDTHS)


def _mla_train_attention(p: MLA, cfg: ArchConfig, h, positions, tables=None):
    """Expanded MLA attention (forward and prefill) -> (output, c_kv,
    k_rope)."""
    b, s, _ = h.shape
    q_nope, q_rope = _mla_q(p, cfg, h, positions, tables)
    c_kv, k_rope = _mla_kv_compressed(p, cfg, h, positions, tables)
    kv = L.linear(p.kv_b, c_kv).reshape(
        b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = torch.split(kv, [cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    if _mla_prefill_kernel(cfg, q_nope):
        out = mla_prefill.mla_prefill(q_nope, q_rope, k_nope, k_rope, v,
                                      scale=cfg.softmax_scale)
    else:
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, cfg.n_heads, cfg.qk_rope_dim)], dim=-1)
        out = L.chunked_attention(q, k, v, causal=cfg.causal,
                                  q_chunk=cfg.q_chunk,
                                  scale=cfg.softmax_scale)
    return L.linear(p.o, out.reshape(b, s, -1)), c_kv, k_rope


def _mla_decode(p: MLA, cfg: ArchConfig, x, positions, c_kv, k_rope,
                length: int):
    """Weight-absorbed MLA for one token against the compressed cache of
    one layer (c_kv (B, Smax, kv_lora), k_rope (B, Smax, rope)), written in
    place at slot ``length % Smax``; slots up to that one are attended
    (the JAX package's mask). Scores in the compressed space, in f32."""
    b = x.shape[0]
    f32 = torch.float32
    q_nope, q_rope = _mla_q(p, cfg, x, positions)  # (B, 1, H, *)
    c_new, k_rope_new = _mla_kv_compressed(p, cfg, x, positions)
    slot = c_kv.shape[1]
    idx = length % slot
    c_kv[:, idx] = c_new[:, 0]
    k_rope[:, idx] = k_rope_new[:, 0]
    wkv = p.kv_b.w.reshape(cfg.kv_lora_rank, cfg.n_heads,
                           cfg.qk_nope_dim + cfg.v_head_dim)
    w_uk, w_uv = wkv[:, :, :cfg.qk_nope_dim], wkv[:, :, cfg.qk_nope_dim:]
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), w_uk.to(f32))
    scale = cfg.softmax_scale
    ckv = c_kv.to(f32)
    s1 = torch.einsum("bhr,bsr->bhs", q_eff, ckv)
    s2 = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(f32), k_rope.to(f32))
    logits = (s1 + s2) * scale
    mask = torch.arange(slot, device=x.device) <= idx
    att = torch.softmax(torch.where(mask, logits, float("-inf")), dim=-1)
    out_c = torch.einsum("bhs,bsr->bhr", att, ckv)
    out = torch.einsum("bhr,rhd->bhd", out_c, w_uv.to(f32))
    return L.linear(p.o, out.reshape(b, 1, -1).to(cfg.dtype))


def _hybrid(p: Layer, att, ssm_y):
    """hymba: the two branches normalised and averaged."""
    return 0.5 * (L.rmsnorm(p.attn_out_norm, att)
                  + L.rmsnorm(p.ssm_out_norm, ssm_y))


def _ffn(p: Layer, cfg: ArchConfig, h, *, decode: bool = False,
         counts: L.MoECounts | None = None):
    """``h`` plus the layer's MLP or MoE on ``ln2(h)`` -> (h, aux). The
    expert-parallel `layers.moe_shardmap` where ``cfg.moe_impl`` asks for
    it, except in a decode step (as in the JAX package); ``counts`` gains
    the MoE's held rows and drops."""
    x = L.rmsnorm(p.ln2, h)
    if p.moe is not None:
        fn = L.moe_shardmap if cfg.moe_impl == "shard_map" and not decode \
            else L.moe
        y, aux = fn(p.moe, x, top_k=cfg.top_k, router_type=cfg.router_type,
                    capacity_factor=cfg.capacity_factor, n_group=cfg.n_group,
                    topk_group=cfg.topk_group,
                    routed_scale=cfg.routed_scaling_factor,
                    expert_offset=cfg.expert_offset, dropless=cfg.dropless,
                    counts=counts)
        return h + y, aux
    with obs.span("repro_torch.lm.mlp"):
        return h + L.mlp(p.mlp, x), None


def _layer_full(p: Layer, cfg: ArchConfig, h, positions, tables,
                counts: L.MoECounts | None = None):
    """One layer over a whole sequence -> (h, aux or None, the layer's
    cache tensors: k / v, c_kv / k_rope, conv / ssm)."""
    p = mesh_ctx.constrain_layer(p)  # ZeRO-3 gather-at-use
    x = L.rmsnorm(p.ln1, h)
    new = {}
    if cfg.ssm:
        y, new = L.ssd_block(p.ssd, x, cfg.ssm_spec)
        return h + y, None, new
    with obs.span("repro_torch.lm.attn"):
        if cfg.mla:
            att, new["c_kv"], new["k_rope"] = _mla_train_attention(
                p.attn, cfg, x, positions, tables)
        else:
            q, k, v = _attn_qkv(p.attn, cfg, x, positions, tables)
            out = L.chunked_attention(q, k, v, causal=cfg.causal,
                                      q_chunk=cfg.q_chunk,
                                      window=cfg.sliding_window)
            att = L.linear(p.attn.o, out.reshape(*x.shape[:2], -1))
            new["k"], new["v"] = k, v
    if cfg.hybrid:
        ssm_y, st = L.ssd_block(p.ssd, x, cfg.ssm_spec)
        new.update(st)
        att = _hybrid(p, att, ssm_y)
    h, aux = _ffn(p, cfg, h + att, counts=counts)
    return h, aux, new


def _layer_train(p: Layer, cfg: ArchConfig, h, positions, tables):
    """One layer for `forward` -> (h, aux or None)."""
    h, aux, _ = _layer_full(p, cfg, h, positions, tables)
    return h, aux


class Head(NamedTuple):
    """The leaves outside the layers, as JAX's ``_head_params`` picks
    them (``embed`` None for embedding inputs)."""

    embed: torch.Tensor | None
    unembed: L.Linear
    final_norm: L.RMSNorm


def _head_params(params: LM) -> Head:
    return mesh_ctx.constrain_head(
        Head(params.embed, params.unembed, params.final_norm))


def _embed_in(params: LM | Head, cfg: ArchConfig, inputs) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        idx = torch.as_tensor(inputs, device=params.embed.device)
        return params.embed[idx.to(torch.int64)]
    return torch.as_tensor(inputs).to(device=params.unembed.w.device,
                                      dtype=cfg.dtype)


def _default_positions(cfg: ArchConfig, b: int, s: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    pos = (offset + torch.arange(s, dtype=torch.int32, device=device)
           )[None, :].expand(b, s)
    if cfg.rope == "mrope":
        pos = pos[None].expand(3, b, s)
    return pos


@L.true_f32()
def forward(params: LM, cfg: ArchConfig, inputs, positions=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. inputs: tokens (B, S) or embeds (B, S, d).
    Returns (logits (B, S, V), aux_loss): the MoE layers' load-balance
    losses summed over the layers, 0 without MoE. Under grad mode each
    layer is recomputed in the backward when ``cfg.remat`` is set; the
    numbers are the same either way."""
    head = _head_params(params)
    h = _embed_in(head, cfg, inputs)
    b, s = h.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, device=h.device)
    else:
        positions = torch.as_tensor(positions, device=h.device)
    tables = _rope_tables(cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for layer in params.layers:
        if remat:
            h, a = checkpoint(_layer_train, layer, cfg, h, positions, tables,
                              use_reentrant=False)
        else:
            h, a = _layer_train(layer, cfg, h, positions, tables)
        if a is not None:
            aux = aux + a
    logits = L.linear(head.unembed, L.rmsnorm(head.final_norm, h))
    return logits, aux


@torch.no_grad()
@L.true_f32()
def features(params: LM, cfg: ArchConfig, inputs, positions=None, *,
             counts: L.MoECounts | None = None) -> torch.Tensor:
    """Sequence features for a classifier head: ``final_norm`` of the last
    hidden state, averaged over the positions in f32 -> (B, d) f32. The
    unembedding is never read. ``counts`` gains every MoE layer's held
    rows and drops (`layers.MoECounts`)."""
    with obs.span("repro_torch.lm.features"):
        head = _head_params(params)
        h = _embed_in(head, cfg, inputs)
        b, s = h.shape[:2]
        if positions is None:
            positions = _default_positions(cfg, b, s, device=h.device)
        else:
            positions = torch.as_tensor(positions, device=h.device)
        tables = _rope_tables(cfg, positions)
        for layer in params.layers:
            h, _, _ = _layer_full(layer, cfg, h, positions, tables, counts)
        h = L.rmsnorm(head.final_norm, h)
        return h.to(torch.float32).mean(dim=1)


def sharded_ce(logits: torch.Tensor, labels) -> torch.Tensor:
    """Per-position cross entropy (B, S) in f32: the log-sum-exp of the
    logits minus the true logit, the max held out of the gradient as in
    the JAX package. The JAX one-hot contraction (there to keep a
    vocabulary-sharded tensor sharded) is a gather here, the same sum: a
    label outside [0, V) has a zero one-hot row, so it picks 0 and its CE
    is the log-sum-exp (`loss_fn` masks labels < 0)."""
    logits = logits.to(torch.float32)
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    v = logits.shape[-1]
    labels = torch.as_tensor(labels, device=logits.device).long()
    true = torch.gather(shifted, -1, labels.clamp(0, v - 1)[..., None])
    return lse - torch.where((labels >= 0) & (labels < v), true[..., 0], 0)


def loss_fn(params: LM, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """Causal-LM CE (decoder) or frame-classification CE (encoder) over
    the labels >= 0, plus the MoE load-balance loss. ``batch`` holds
    ``inputs``, ``labels`` and, for M-RoPE, ``positions`` (tensors or
    numpy)."""
    logits, aux = forward(params, cfg, batch["inputs"],
                          batch.get("positions"))
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    nll = sharded_ce(logits, labels)
    mask = labels >= 0
    return (nll * mask).sum() / mask.sum().clamp_min(1) + aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-family caches
# ---------------------------------------------------------------------------

class Cache(NamedTuple):
    """The JAX package's unified cache; unused fields are None per family.

    k/v:     (L, B, Smax, KV, hd)   attention KV
    c_kv:    (L, B, Smax, kv_lora)  MLA compressed KV
    k_rope:  (L, B, Smax, rope_dim) MLA shared rope key
    conv:    (L, B, 3, conv_dim)    SSM conv state (cfg.dtype)
    ssm:     (L, B, H, P, N)        SSM state (f32)
    length:  int                    tokens already in the cache
    """

    k: torch.Tensor | None
    v: torch.Tensor | None
    c_kv: torch.Tensor | None
    k_rope: torch.Tensor | None
    conv: torch.Tensor | None
    ssm: torch.Tensor | None
    length: int


#: the cache's tensor fields, every one batched at axis 1
CACHE_FIELDS = ("k", "v", "c_kv", "k_rope", "conv", "ssm")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Cache:
    """A zero cache on ``device`` (the card unless the caller asks for the
    CPU); a sliding window keeps a ring of ``min(max_len, window)`` slots.
    The SSM conv state has 3 slots, as in the JAX package."""
    dt, dev = dtype or cfg.dtype, resolve(device)
    n, b = cfg.n_layers, batch
    k = v = c_kv = k_rope = conv = ssm = None
    if cfg.ssm or cfg.hybrid:
        spec = cfg.ssm_spec
        conv = torch.zeros((n, b, 3, spec.d_inner + 2 * spec.d_state),
                           dtype=dt, device=dev)
        ssm = torch.zeros((n, b, spec.n_heads, spec.head_dim, spec.d_state),
                          dtype=torch.float32, device=dev)
    if cfg.mla:
        c_kv = torch.zeros((n, b, max_len, cfg.kv_lora_rank), dtype=dt,
                           device=dev)
        k_rope = torch.zeros((n, b, max_len, cfg.qk_rope_dim), dtype=dt,
                             device=dev)
    elif cfg.uses_attention:
        attn_len = min(max_len, cfg.sliding_window) if cfg.sliding_window \
            else max_len
        k = torch.zeros((n, b, attn_len, padded_heads(cfg)[1], cfg.head_dim),
                        dtype=dt, device=dev)
        v = torch.zeros_like(k)
    return Cache(k, v, c_kv, k_rope, conv, ssm, 0)


@torch.no_grad()
@L.true_f32()
def prefill(params: LM, cfg: ArchConfig, inputs, positions=None,
            max_len: int | None = None) -> tuple[torch.Tensor, Cache]:
    """Process a prompt, building the serving cache.

    Returns (last-position logits (B, V), cache ready for `decode_step`).
    A sliding window lays the last ``w`` keys out on their ring slots
    ``p % w``; an SSM layer leaves its conv and ssm states."""
    head = _head_params(params)
    h = _embed_in(head, cfg, inputs)
    b, s = h.shape[:2]
    if positions is None:
        positions = _default_positions(cfg, b, s, device=h.device)
    else:
        positions = torch.as_tensor(positions, device=h.device)
    max_len = max_len or s
    tables = _rope_tables(cfg, positions)
    # a prompt longer than max_len keeps all its keys (as the JAX pad)
    cache = init_cache(cfg, b, max_len if cfg.sliding_window
                       else max(max_len, s), device=h.device)
    for i, layer in enumerate(params.layers):
        h, _, new = _layer_full(layer, cfg, h, positions, tables)
        if "k" in new:
            k, v = new["k"], new["v"]
            w = cache.k.shape[2]
            if cfg.sliding_window and s >= w:
                k = torch.roll(k[:, -w:], s % w, dims=1)
                v = torch.roll(v[:, -w:], s % w, dims=1)
            cache.k[i, :, :k.shape[1]] = k
            cache.v[i, :, :v.shape[1]] = v
        for f in ("c_kv", "k_rope"):
            if f in new:
                getattr(cache, f)[i, :, :s] = new[f]
        for f in ("conv", "ssm"):
            if f in new:
                getattr(cache, f)[i] = new[f]
    h = L.rmsnorm(head.final_norm, h)
    logits = L.linear(head.unembed, h[:, -1])
    return logits, cache._replace(length=s)


def _layer_decode(p: Layer, cfg: ArchConfig, h, cache_l: dict,
                  length: int):
    """One layer, one token: ``h`` (B, 1, d) against this layer's cache
    slices ``cache_l`` (`_cache_layer_fields`: (B, Smax, ...) each), the
    new token's state written into them in place at ``length`` (a Python
    int) -> (h, cache_l)."""
    p = mesh_ctx.constrain_layer(p)  # ZeRO-3 gather-at-use
    b = h.shape[0]
    positions = _default_positions(cfg, b, 1, offset=length,
                                   device=h.device)
    x = L.rmsnorm(p.ln1, h)
    ssm_y = None
    if p.ssd is not None:
        ssm_y, st = L.ssd_block(
            p.ssd, x, cfg.ssm_spec,
            state={"conv": cache_l["conv"], "ssm": cache_l["ssm"]})
        cache_l["conv"].copy_(st["conv"])
        cache_l["ssm"].copy_(st["ssm"])
    if cfg.ssm:
        return h + ssm_y, cache_l
    if cfg.mla:
        att = _mla_decode(p.attn, cfg, x, positions, cache_l["c_kv"],
                          cache_l["k_rope"], length)
    else:
        smax = cache_l["k"].shape[1]
        # ring buffer for a sliding window: all slots valid once full;
        # past the end the write lands on the last slot (XLA clamps a
        # dynamic_update_slice start the same way)
        idx = length % smax if cfg.sliding_window else min(length, smax - 1)
        cur = min(length + 1, smax) if cfg.sliding_window else length + 1
        q, k, v = _attn_qkv(p.attn, cfg, x, positions)
        cache_l["k"][:, idx] = k[:, 0]
        cache_l["v"][:, idx] = v[:, 0]
        out = L.decode_attention(q, cache_l["k"], cache_l["v"], cur)
        att = L.linear(p.attn.o, out.reshape(b, 1, -1))
    if cfg.hybrid:
        att = _hybrid(p, att, ssm_y)
    h, _ = _ffn(p, cfg, h + att, decode=True)
    return h, cache_l


def _cache_layer_fields(cfg: ArchConfig) -> list[str]:
    """The cache fields a layer of ``cfg`` holds."""
    fields = []
    if cfg.mla:
        fields += ["c_kv", "k_rope"]
    elif cfg.uses_attention:
        fields += ["k", "v"]
    if cfg.ssm or cfg.hybrid:
        fields += ["conv", "ssm"]
    return fields


@torch.no_grad()
@L.true_f32()
def decode_step(params: LM, cfg: ArchConfig, tokens, cache: Cache
                ) -> tuple[torch.Tensor, Cache]:
    """One decode step. tokens: (B, 1) ids (or (B, 1, d) embeds).
    Returns (logits (B, 1, V), the cache with ``length + 1``; its tensors
    are updated in place, layer by layer through `_layer_decode`)."""
    head = _head_params(params)
    h = _embed_in(head, cfg, tokens)
    length = int(cache.length)
    fields = _cache_layer_fields(cfg)
    for i, layer in enumerate(params.layers):
        h, _ = _layer_decode(layer, cfg, h,
                             {f: getattr(cache, f)[i] for f in fields},
                             length)
    logits = L.linear(head.unembed, L.rmsnorm(head.final_norm, h))
    return logits, cache._replace(length=length + 1)
