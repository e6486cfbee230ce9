"""The LM zoo's dense families, in PyTorch (inference).

One config dataclass and one model for the architectures with no MoE, MLA
or SSM: dense GQA transformers (llama / qwen, optional QKV bias and
qk-norm), VLM backbones (M-RoPE, embeddings as input) and encoder-only
backbones (hubert). The rest of the JAX package's zoo raises
`NotImplementedError` until its slice lands (ROADMAP §A).

The model is an `LM` module: ``embed`` (V, d) for token inputs, ``unembed``
(a `layers.Linear`), ``final_norm`` and ``layers``, an `nn.ModuleList` of
`Layer`s. Every parameter carries the JAX leaf name and layout, so the JAX
pytree (layers stacked on axis 0) maps onto it name by name
(`repro_torch.convert.lm_params_from_numpy`).

Entry points (the JAX package's names):
    init_params(key, cfg, device=None)        -> LM
    forward(params, cfg, tokens/embeds)       -> (logits, aux)
    prefill(params, cfg, inputs, max_len=...) -> (last logits, Cache)
    decode_step(params, cfg, tokens, cache)   -> (logits (B, 1, V), Cache)

`Cache` keeps the JAX contract: ``k``/``v`` are (L, B, Smax, KV, hd), the
batch at axis 1, with one shared ``length`` (a Python int here: the port
runs eagerly). `decode_step` writes the new token's keys and values into
the cache's tensors in place and returns the cache with ``length + 1``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve
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
    router_type: str = "softmax"
    capacity_factor: float = 1.25
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
    #: (a multi-device layout: raises here, ROADMAP §A.3)
    head_pad_multiple: int = 0

    @property
    def uses_attention(self) -> bool:
        return not self.ssm

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
        """Analytic parameter count (for MODEL_FLOPS and reporting)."""
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
        if self.n_experts > 0:
            per += d * self.n_experts  # router
            per += self.n_experts * 3 * d * self.d_ff_expert
            per += self.n_shared_experts * 3 * d * self.d_ff_expert
        elif self.d_ff > 0:
            per += 3 * d * self.d_ff
        return n + self.n_layers * per

    def active_param_count(self) -> int:
        """Activated params per token (MoE top-k), for 6*N_active*D."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        per_moe_total = self.n_experts * 3 * d * self.d_ff_expert
        per_moe_active = (self.top_k + self.n_shared_experts) * 3 * d \
            * self.d_ff_expert
        return self.param_count() - self.n_layers * (per_moe_total
                                                     - per_moe_active)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the families and layouts whose slice has not landed."""
    later = [("n_experts > 0", cfg.n_experts > 0, "MoE"),
             ("mla", cfg.mla, "MLA"), ("ssm", cfg.ssm, "the Mamba2 SSD"),
             ("hybrid", cfg.hybrid, "hymba's hybrid heads")]
    for flag, on, what in later:
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {flag} ({what}) is not in the port yet "
                "(ROADMAP §A.2)")
    if cfg.head_pad_multiple > 0:
        raise NotImplementedError(
            f"{cfg.name}: head_pad_multiple > 0 is a tensor-parallel head "
            "layout, which comes with the multi-GPU slice (ROADMAP §A.3)")


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


class Layer(nn.Module):
    def __init__(self, ln1: L.RMSNorm, attn: Attention, ln2: L.RMSNorm,
                 mlp: L.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor | None, unembed: L.Linear,
                 final_norm: L.RMSNorm, layers: list[Layer]):
        super().__init__()
        self.embed = None if embed is None else nn.Parameter(
            embed, requires_grad=False)
        self.unembed, self.final_norm = unembed, final_norm
        self.layers = nn.ModuleList(layers)


def _init_attn(g: torch.Generator, cfg: ArchConfig) -> Attention:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.dtype
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = L.linear_init(g, d, H * hd, bias=cfg.qkv_bias, dtype=dt)
    k = L.linear_init(g, d, KV * hd, bias=cfg.qkv_bias, dtype=dt)
    v = L.linear_init(g, d, KV * hd, bias=cfg.qkv_bias, dtype=dt)
    o = L.linear_init(g, H * hd, d, dtype=dt)
    if not cfg.qk_norm:
        return Attention(q, k, v, o)
    return Attention(q, k, v, o, L.rmsnorm_init(hd, device=g.device),
                     L.rmsnorm_init(hd, device=g.device))


def _init_layer(g: torch.Generator, cfg: ArchConfig) -> Layer:
    return Layer(L.rmsnorm_init(cfg.d_model, device=g.device),
                 _init_attn(g, cfg),
                 L.rmsnorm_init(cfg.d_model, device=g.device),
                 L.mlp_init(g, cfg.d_model, cfg.d_ff, dtype=cfg.dtype))


def init_params(key: int | torch.Generator, cfg: ArchConfig, *,
                device=None) -> LM:
    """Random weights in the JAX package's distributions (normal times
    ``din ** -0.5``, the embedding normal times 0.02), drawn in order from
    ``key`` (a seed, or a generator on the target device) on ``device``
    (the card unless the caller asks for the CPU)."""
    check_supported(cfg)
    if isinstance(key, torch.Generator):
        g = key
    else:
        g = torch.Generator(device=resolve(device)).manual_seed(int(key))
    embed = None
    if cfg.input_mode == "tokens":
        embed = (L._normal((cfg.vocab, cfg.d_model), g) * 0.02).to(cfg.dtype)
    unembed = L.linear_init(g, cfg.d_model, cfg.vocab, dtype=cfg.dtype)
    layers = [_init_layer(g, cfg) for _ in range(cfg.n_layers)]
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
    return L.apply_rope(x, positions, cfg.rope_theta, tables=tables)


def _rope_tables(cfg: ArchConfig, positions):
    """Step-level rope tables (`precompute_rope`), built once."""
    if not cfg.precompute_rope or cfg.rope != "standard":
        return None
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _attn_qkv(p: Attention, cfg: ArchConfig, h, positions, tables=None):
    b, s, _ = h.shape
    q = L.linear(p.q, h).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.linear(p.k, h).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.linear(p.v, h).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(p.q_norm, q)
        k = L.rmsnorm(p.k_norm, k)
    return _rope(cfg, q, positions, tables), _rope(cfg, k, positions,
                                                   tables), v


def _attend_full(p: Layer, cfg: ArchConfig, h, positions, tables):
    """One layer over a whole sequence -> (h, k, v)."""
    x = L.rmsnorm(p.ln1, h)
    q, k, v = _attn_qkv(p.attn, cfg, x, positions, tables)
    out = L.chunked_attention(q, k, v, causal=cfg.causal,
                              q_chunk=cfg.q_chunk, window=cfg.sliding_window)
    h = h + L.linear(p.attn.o, out.reshape(*x.shape[:2], -1))
    return h + L.mlp(p.mlp, L.rmsnorm(p.ln2, h)), k, v


def _embed_in(params: LM, cfg: ArchConfig, inputs) -> torch.Tensor:
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


def forward(params: LM, cfg: ArchConfig, inputs, positions=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. inputs: tokens (B, S) or embeds (B, S, d).
    Returns (logits (B, S, V), aux_loss), aux 0 without MoE."""
    check_supported(cfg)
    with torch.no_grad():
        h = _embed_in(params, cfg, inputs)
        b, s = h.shape[:2]
        if positions is None:
            positions = _default_positions(cfg, b, s, device=h.device)
        tables = _rope_tables(cfg, positions)
        for layer in params.layers:
            h, _, _ = _attend_full(layer, cfg, h, positions, tables)
        logits = L.linear(params.unembed, L.rmsnorm(params.final_norm, h))
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------------------
# serving: prefill + decode with a KV cache
# ---------------------------------------------------------------------------

class Cache(NamedTuple):
    """The JAX package's unified cache; the MLA / SSM fields stay None
    until their slices land.

    k/v:    (L, B, Smax, KV, hd)   attention KV
    length: int                    tokens already in the cache
    """

    k: torch.Tensor | None
    v: torch.Tensor | None
    c_kv: torch.Tensor | None
    k_rope: torch.Tensor | None
    conv: torch.Tensor | None
    ssm: torch.Tensor | None
    length: int


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device=None) -> Cache:
    """A zero cache on ``device`` (the card unless the caller asks for the
    CPU); a sliding window keeps a ring of ``min(max_len, window)`` slots."""
    check_supported(cfg)
    attn_len = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    shape = (cfg.n_layers, batch, attn_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve(device)
    k = torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev)
    return Cache(k, torch.zeros_like(k), None, None, None, None, 0)


def prefill(params: LM, cfg: ArchConfig, inputs, positions=None,
            max_len: int | None = None) -> tuple[torch.Tensor, Cache]:
    """Process a prompt, building the serving cache.

    Returns (last-position logits (B, V), cache ready for `decode_step`).
    A sliding window lays the last ``w`` keys out on their ring slots
    ``p % w``."""
    check_supported(cfg)
    with torch.no_grad():
        h = _embed_in(params, cfg, inputs)
        b, s = h.shape[:2]
        if positions is None:
            positions = _default_positions(cfg, b, s, device=h.device)
        max_len = max_len or s
        tables = _rope_tables(cfg, positions)
        # a prompt longer than max_len keeps all its keys (as the JAX pad)
        cache = init_cache(cfg, b, max_len if cfg.sliding_window
                           else max(max_len, s), device=h.device)
        w = cache.k.shape[2]
        for i, layer in enumerate(params.layers):
            h, k, v = _attend_full(layer, cfg, h, positions, tables)
            if cfg.sliding_window and s >= w:
                k = torch.roll(k[:, -w:], s % w, dims=1)
                v = torch.roll(v[:, -w:], s % w, dims=1)
            cache.k[i, :, :k.shape[1]] = k
            cache.v[i, :, :v.shape[1]] = v
        h = L.rmsnorm(params.final_norm, h)
        logits = L.linear(params.unembed, h[:, -1])
    return logits, cache._replace(length=s)


def decode_step(params: LM, cfg: ArchConfig, tokens, cache: Cache
                ) -> tuple[torch.Tensor, Cache]:
    """One decode step. tokens: (B, 1) ids (or (B, 1, d) embeds).
    Returns (logits (B, 1, V), the cache with ``length + 1``; its k/v
    tensors are updated in place)."""
    check_supported(cfg)
    with torch.no_grad():
        h = _embed_in(params, cfg, tokens)
        b = h.shape[0]
        length = int(cache.length)
        positions = _default_positions(cfg, b, 1, offset=length,
                                       device=h.device)
        smax = cache.k.shape[2]
        # ring buffer for a sliding window: all slots valid once full;
        # past the end the write lands on the last slot (XLA clamps a
        # dynamic_update_slice start the same way)
        idx = length % smax if cfg.sliding_window else min(length, smax - 1)
        cur = min(length + 1, smax) if cfg.sliding_window else length + 1
        for i, layer in enumerate(params.layers):
            x = L.rmsnorm(layer.ln1, h)
            q, k, v = _attn_qkv(layer.attn, cfg, x, positions)
            cache.k[i, :, idx] = k[:, 0]
            cache.v[i, :, idx] = v[:, 0]
            out = L.decode_attention(q, cache.k[i], cache.v[i], cur)
            h = h + L.linear(layer.attn.o, out.reshape(b, 1, -1))
            h = h + L.mlp(layer.mlp, L.rmsnorm(layer.ln2, h))
        logits = L.linear(params.unembed, L.rmsnorm(params.final_norm, h))
    return logits, cache._replace(length=length + 1)
