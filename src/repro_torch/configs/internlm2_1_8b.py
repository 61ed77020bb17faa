"""internlm2-1.8b — copy of ``repro/configs/internlm2_1_8b.py``.

[dense] internlm2-1.8b — GQA [arXiv:2403.17297; hf]
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544
"""
from repro_torch.configs.base import ArchConfig

INTERNLM2_1_8B = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
    layer_pattern=("attn",),
    norm="rmsnorm",
    act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

CONFIG = INTERNLM2_1_8B
