"""gemma3-1b — copy of ``repro/configs/gemma3_1b.py``.

[dense] gemma3-1b — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt;
unverified]. 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
"""
from repro_torch.configs.base import ArchConfig

GEMMA3_1B = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    layer_pattern=("swa",) * 5 + ("attn",),  # 5 local : 1 global
    window=512,
    norm="rmsnorm",
    act="gelu",
    rope_theta=1_000_000.0,  # global layers (local layers use 10k upstream)
    tie_embeddings=True,
)

CONFIG = GEMMA3_1B
