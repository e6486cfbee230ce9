"""tinyllama-1.1b [dense] — llama2-arch small, GQA kv=4. [arXiv:2401.02385; hf]"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632, vocab=32000, rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="tinyllama-1.1b-smoke", family="dense",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, q_chunk=64,
)
