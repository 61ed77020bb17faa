"""mamba2-130m — copy of ``repro/configs/mamba2_130m.py``.

[ssm] mamba2-130m — SSD (state-space duality) [arXiv:2405.21060; unverified]
24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

MAMBA2_130M = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # d_inner / head_dim = 1536/64 (bookkeeping)
    num_kv_heads=24,
    d_ff=0,                  # attn-free, no separate FFN (mamba block only)
    vocab_size=50_280,
    layer_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256,
                  conv_width=4, n_groups=1),
    norm="rmsnorm",
    tie_embeddings=True,
    sub_quadratic=True,
)

CONFIG = MAMBA2_130M
