"""whisper-tiny — copy of ``repro/configs/whisper_tiny.py``.

[audio] whisper-tiny — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified]. 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865
"""
from repro_torch.configs.base import ArchConfig, EncoderConfig

WHISPER_TINY = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    layer_pattern=("attn",),
    encoder=EncoderConfig(num_layers=4, max_source_len=1500),
    norm="layernorm",
    act="gelu_mlp",          # whisper uses a non-gated GELU MLP
    tie_embeddings=True,
    sub_quadratic=False,
)

CONFIG = WHISPER_TINY
