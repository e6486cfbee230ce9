"""qwen3-1.7b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, qk_norm=True, q_chunk=64,
)
