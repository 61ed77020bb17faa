"""minicpm3-4b — copy of ``repro/configs/minicpm3_4b.py``.

[dense] minicpm3-4b — MLA [hf:openbmb/MiniCPM3-4B; hf]
62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448
"""
from repro_torch.configs.base import ArchConfig, MLAConfig

MINICPM3_4B = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=96,             # qk_nope + qk_rope = 64 + 32
    d_ff=6400,
    vocab_size=73_448,
    layer_pattern=("mla",),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    norm="rmsnorm",
    act="silu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

CONFIG = MINICPM3_4B
