"""hubert-xlarge [audio] — encoder-only transformer backbone.
[arXiv:2106.07447; unverified]

The conv waveform frontend is a STUB per the brief: input_specs() provides
precomputed frame embeddings (B, T, 1280). The 504-unit masked-prediction
head is also where the paper's ACAM template-matching head applies
(DESIGN.md §5) — 504 classes is ACAM-scale.
"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, causal=False, input_mode="embeds",
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="hubert-smoke", family="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=64, causal=False, input_mode="embeds", q_chunk=64,
)
