"""hymba-1.5b [hybrid] — parallel attn + mamba heads, GQA kv=5.
[arXiv:2411.13676; hf]

Deviations (DESIGN.md §6): meta-tokens omitted; sliding-window attention
(window 1024) for the attention branch so long_500k decode is sub-quadratic,
matching hymba's SWA-in-most-layers design.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    hybrid=True, ssm_state=16, ssm_headdim=64,
    sliding_window=1024, rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    hybrid=True, ssm_state=16, ssm_headdim=32, ssm_chunk=32,
    sliding_window=64, q_chunk=64,
)
