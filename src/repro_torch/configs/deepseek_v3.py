"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, sigmoid router.
[arXiv:2412.19437; hf]

Deviations (DESIGN.md §6): the 3 leading dense layers are folded into the
homogeneous MoE scan; the MTP head is omitted.

``PUBLISHED`` is the model as its config.json states it, on the port alone
(not in the registry, which mirrors the JAX package's): the 3 leading
dense layers (SwiGLU 18,432), the ``noaux_tc`` router (sigmoid scores plus
a score-correction bias choose the top 8 within the best 4 of 8 groups;
the unbiased scores, renormalised, times 2.5 weight them), YaRN on the 64
rope dims (factor 40 over 4,096 positions, beta 32 / 1, mscale 1) and
dropless routing; the MTP module is left out. ``PUBLISHED_SMOKE`` has its
every feature at CPU-test widths, with 4 of its 16 experts held.
"""
import dataclasses

from repro_torch.models.layers import YaRN
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab=129280,
    n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    router_type="sigmoid",
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="deepseek-v3-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab=512,
    n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=128,
    router_type="sigmoid",
    mla=True, q_lora_rank=64, kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, q_chunk=64,
)

PUBLISHED = dataclasses.replace(
    CONFIG, d_ff=18432, first_k_dense=3,
    router_type="sigmoid_group", n_group=8, topk_group=4, router_bias=True,
    routed_scaling_factor=2.5, dropless=True,
    yarn=YaRN(factor=40.0, original_max=4096, beta_fast=32.0, beta_slow=1.0,
              mscale=1.0, mscale_all_dim=1.0))

PUBLISHED_SMOKE = dataclasses.replace(
    PUBLISHED, name="deepseek-v3-published-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=96, vocab=256, first_k_dense=1,
    n_experts=16, top_k=4, d_ff_expert=32, n_group=4, topk_group=2,
    experts_held=4, expert_offset=0,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, q_chunk=16,
    yarn=YaRN(factor=40.0, original_max=64, beta_fast=32.0, beta_slow=1.0,
              mscale=1.0, mscale_all_dim=1.0))
