"""qwen1.5-32b [dense] — QKV bias, kv=40 (full MHA). [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
    d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="qwen1.5-32b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, qkv_bias=True, q_chunk=64,
)
