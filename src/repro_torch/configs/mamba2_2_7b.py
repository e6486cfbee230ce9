"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.lm import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280,
    ssm=True, ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    rope="none",
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=1, n_kv_heads=1, head_dim=32,
    d_ff=0, vocab=512,
    ssm=True, ssm_state=16, ssm_headdim=32, ssm_expand=2, ssm_chunk=32,
    rope="none",
)
