"""Architecture configuration: the port's copy of ``repro/configs/base.py``.

Only what the dense attention-only archs need is here; the family
sub-configs (MLA, SSM, RG-LRU, enc-dec, VLM) arrive with the slices that
port those families. ``moe`` is kept as a field so the FFN can refuse an
MoE config by name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds usable in `layer_pattern` (the port serves "attn" and "swa"):
#   "attn" — full causal GQA/MQA attention
#   "swa"  — sliding-window attention (window = cfg.window)
BLOCK_KINDS = ("attn", "swa")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ...
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

    moe: Optional[object] = None  # MoE is not ported yet (ROADMAP A10)

    norm: str = "rmsnorm"  # gemma-style rmsnorm (the only kind ported)
    act: str = "silu"  # gated MLP activation: silu | gelu (tanh-approximate)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    logits_softcap: float = 0.0

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer block-kind list of length num_layers."""
        pat = self.layer_pattern
        kinds = tuple(pat[i % len(pat)] for i in range(self.num_layers))
        for k in kinds:
            if k not in BLOCK_KINDS:
                raise ValueError(f"block kind {k!r} is not ported yet")
        return kinds

    def param_count(self) -> int:
        """Parameters of the dense decoder: embedding (+ untied head),
        per-layer norms, attention and MLP, final norm."""
        d, dh = self.d_model, self.resolved_head_dim
        attn = d * dh * (2 * self.num_heads + 2 * self.num_kv_heads)
        mlp = 3 * d * self.d_ff  # gated: w_up, w_gate, w_down
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return embed + self.num_layers * (attn + mlp + 2 * d) + d

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests (the same
        reduction as ``repro``'s, so the two packages build equal shapes)."""
        return self.scaled(
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
