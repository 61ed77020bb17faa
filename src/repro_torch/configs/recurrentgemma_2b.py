"""recurrentgemma-2b — copy of ``repro/configs/recurrentgemma_2b.py``.

[hybrid] recurrentgemma-2b — RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf]
26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

RECURRENTGEMMA_2B = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "swa"),  # 2 recurrent : 1 local attn
    window=2048,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    norm="rmsnorm",
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    sub_quadratic=True,
)

CONFIG = RECURRENTGEMMA_2B
