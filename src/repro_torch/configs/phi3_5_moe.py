"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2, GQA kv=8.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064, n_experts=16, top_k=2, d_ff_expert=6400,
    router_type="softmax", rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, n_experts=4, top_k=2, d_ff_expert=256, q_chunk=64,
)
