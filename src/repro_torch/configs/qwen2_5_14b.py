"""qwen2.5-14b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen2.5-14b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, qkv_bias=True, q_chunk=64,
)
