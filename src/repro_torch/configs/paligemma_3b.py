"""paligemma-3b — copy of ``repro/configs/paligemma_3b.py``.

[vlm] paligemma-3b — SigLIP + gemma [arXiv:2407.07726; hf]
18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216
"""
from repro_torch.configs.base import ArchConfig

PALIGEMMA_3B = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    layer_pattern=("attn",),
    num_prefix_tokens=256,   # 224px / 14 patch -> 16 x 16 tokens (stub)
    vision_width=1152,       # SigLIP-So400m width
    norm="rmsnorm",
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    sub_quadratic=False,
)

CONFIG = PALIGEMMA_3B
