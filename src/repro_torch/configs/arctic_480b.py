"""arctic-480b — copy of ``repro/configs/arctic_480b.py``.

[moe] arctic-480b — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

ARCTIC_480B = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32_000,
    layer_pattern=("attn",),
    moe=MoEConfig(num_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual_d_ff=4864, group_size=512),
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=False,
    sub_quadratic=False,
    optimizer="adafactor",   # Adam f32 state for 480B params exceeds 512×16GB
)

CONFIG = ARCTIC_480B
