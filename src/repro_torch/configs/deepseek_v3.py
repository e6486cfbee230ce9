"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, sigmoid router.
[arXiv:2412.19437; hf]

Deviations (DESIGN.md §6): the 3 leading dense layers are folded into the
homogeneous MoE scan; the MTP head is omitted.
"""
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
