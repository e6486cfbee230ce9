"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

The vision frontend is a STUB per the brief: input_specs() provides
precomputed patch embeddings (B, S, d_model); this config is the LM backbone.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, qkv_bias=True,
    rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    input_mode="embeds",
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, qkv_bias=True,
    rope="mrope", mrope_sections=(4, 6, 6),
    input_mode="embeds", q_chunk=64,
)
