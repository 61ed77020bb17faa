"""mixtral-8x7b — copy of ``repro/configs/mixtral_8x7b.py``.

[moe] mixtral-8x7b — 8 experts top-2, SWA [arXiv:2401.04088; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

MIXTRAL_8X7B = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    layer_pattern=("swa",),
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25,
                  group_size=512),
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    sub_quadratic=True,      # SWA bounds the KV cache to the window
)

CONFIG = MIXTRAL_8X7B
