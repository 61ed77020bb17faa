"""Architecture configuration: the port's copy of ``repro/configs/base.py``.

Every field of ``repro``'s ``ArchConfig`` is here: the dense attention
archs, MLA (minicpm3-4b), MoE (mixtral-8x7b), the Mamba-2 SSD mixer
(mamba2-130m), the RG-LRU mixer (recurrentgemma-2b), the enc-dec family's
``encoder`` (whisper-tiny) and the VLM family's ``num_prefix_tokens`` and
``vision_width`` (paligemma-3b). Every field is equal for every ported arch,
full and smoke (``tests/test_torch_train.py``). ``ShapeConfig`` and
``SHAPES`` are copies.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple



@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    """Capacity-bounded top-k MoE (GShard-style dispatch, experts sharded
    over the TP ring)."""

    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # Arctic: a small dense FFN runs in parallel (residual) with the MoE.
    dense_residual_d_ff: int = 0
    # Token group size for the dispatch einsum (bounds the one-hot tensor).
    group_size: int = 512
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality, chunked dual form)."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU recurrent block (RecurrentGemma / Griffin)."""

    lru_width: int = 2560
    conv_width: int = 4
    block_width: int = 0  # 0 => d_model


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of an enc-dec arch (whisper). The frontend is a stub:
    the inputs are precomputed frame embeddings (B, T_enc, d_model)."""

    num_layers: int = 4
    max_source_len: int = 1500


# Block kinds usable in `layer_pattern`:
#   "attn"  — full causal GQA/MQA attention
#   "swa"   — sliding-window attention (window = cfg.window)
#   "mla"   — multi-head latent attention (cfg.mla)
#   "ssm"   — Mamba-2 SSD mixer (cfg.ssm)
#   "rglru" — RG-LRU recurrent mixer (cfg.rglru)
BLOCK_KINDS = ("attn", "swa", "mla", "ssm", "rglru")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | ...
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # Per-layer mixer pattern, cycled over `num_layers`
    # e.g. ("swa",)*5 + ("attn",) for gemma3's 5 local : 1 global.
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # sliding window for "swa" blocks

    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # enc-dec (whisper): the decoder's fields above, the encoder stack here
    encoder: Optional[EncoderConfig] = None
    # vlm (paligemma): image-prefix tokens the stub frontend supplies as
    # precomputed patch embeddings of width vision_width (projected in)
    num_prefix_tokens: int = 0
    vision_width: int = 0

    norm: str = "rmsnorm"  # rmsnorm (gemma-style) | layernorm
    act: str = "silu"  # silu | gelu (gated) | gelu_mlp (non-gated)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    logits_softcap: float = 0.0
    # eligible for the long_500k shape (sub-quadratic or bounded-KV mixers)
    sub_quadratic: bool = False
    # optimizer default (the huge MoE archs use adafactor)
    optimizer: str = "adamw"

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer block-kind list of length num_layers."""
        pat = self.layer_pattern
        kinds = tuple(pat[i % len(pat)] for i in range(self.num_layers))
        for k in kinds:
            if k not in BLOCK_KINDS:
                raise ValueError(f"block kind {k!r} is not ported yet")
        return kinds

    def _mixer_param_count(self, kind: str) -> int:
        """Parameters of one block's mixer, by the shapes the model builds."""
        d, H = self.d_model, self.num_heads
        if kind == "ssm":
            s = self.ssm
            d_inner = s.expand * d
            nheads = d_inner // s.head_dim
            conv_ch = d_inner + 2 * s.n_groups * s.d_state
            return (d * (d_inner + conv_ch + nheads)      # w_in
                    + (s.conv_width + 1) * conv_ch        # conv_w, conv_b
                    + 3 * nheads                          # A_log, dt_bias, D
                    + d_inner                             # norm_scale
                    + d_inner * d)                        # w_out
        if kind == "rglru":
            r = self.rglru
            w = r.block_width or r.lru_width or d
            return (3 * d * w                             # w_y, w_x, w_out
                    + (r.conv_width + 1) * w              # conv_w, conv_b
                    + 5 * w)                              # gates, Lambda
        if kind == "mla":
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            return (d * m.q_lora_rank + m.q_lora_rank           # wq_a, q_norm
                    + m.q_lora_rank * H * qk                    # wq_b
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)  # wkv_a
                    + m.kv_lora_rank                            # kv_norm
                    + m.kv_lora_rank * H * (m.qk_nope_head_dim
                                            + m.v_head_dim)     # wk_b, wv_b
                    + H * m.v_head_dim * d)                     # wo
        dh = self.resolved_head_dim
        return d * dh * (2 * H + 2 * self.num_kv_heads)         # wq wk wv wo

    def _ffn_param_count(self) -> int:
        """Parameters of one block's FFN: the dense MLP (w_up, w_down and,
        gated, w_gate), or the MoE router (d, E), E experts' gated MLPs and
        the dense residual MLP where there is one."""
        d = self.d_model
        m = self.moe
        if m is None:
            return (3 if self.act in ("silu", "gelu") else 2) * d * self.d_ff
        return (d * m.num_experts + m.num_experts * 3 * d * self.d_ff
                + 3 * d * m.dense_residual_d_ff)

    def _norm_param_count(self) -> int:
        """One norm: its scale, and a layernorm's bias."""
        return self.d_model * (2 if self.norm == "layernorm" else 1)

    def param_count(self) -> int:
        """Parameters of the model (``repro``'s count of the same init
        shapes): the embedding (+ untied head), per-layer norms, mixer and
        FFN (every expert counted; none where d_ff is 0 and there is no
        MoE) and the final norm; an enc-dec's encoder blocks (self-attention
        + MLP), encoder norm and each decoder block's cross-attention and
        its norm; a VLM's ``vision_proj``."""
        d, n = self.d_model, self._norm_param_count()
        has_ffn = self.d_ff > 0 or self.moe is not None
        ffn = (self._ffn_param_count() + n) if has_ffn else 0
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        blocks = sum(self._mixer_param_count(k) + ffn + n
                     for k in self.layer_kinds())
        total = embed + blocks + n + self.vision_width * d
        if self.encoder is not None:
            attn = self._mixer_param_count("attn")
            total += self.encoder.num_layers * (attn + ffn + n) + n
            total += self.num_layers * (attn + n)        # cross-attention
        return total

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests (the same
        reduction as ``repro``'s, so the two packages build equal shapes)."""
        kw = dict(
            num_layers=max(2, len(self.layer_pattern)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads > 1
            else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window=min(self.window, 8) if self.window else 0,
        )
        if self.mla:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=8, v_head_dim=8)
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                group_size=16,
                dense_residual_d_ff=64 if self.moe.dense_residual_d_ff else 0)
        if self.ssm:
            kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2,
                                  chunk_size=8, conv_width=4)
        if self.rglru:
            kw["rglru"] = RGLRUConfig(lru_width=64, conv_width=4)
        if self.encoder:
            kw["encoder"] = EncoderConfig(num_layers=2, max_source_len=16)
        if self.num_prefix_tokens:
            kw["num_prefix_tokens"] = 4
            kw["vision_width"] = 32
        return self.scaled(**kw)


# ---------------------------------------------------------------------------
# ShapeConfig: the assigned input-shape set
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
