"""FLOP counts the period planner reads. Counterpart of the part of
``repro/models/counting.py`` that the dense period path uses; the parameter
count lives on :meth:`repro_torch.configs.base.ArchConfig.param_count`."""
from __future__ import annotations


def attention_core_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one block's attention core (QK^T logits + softmax·V), the
    planner ``comp_hints`` source: 2 matmuls of 2·B·H·S²·dh each, halved by
    the causal mask → 2·B·H·S²·dh. Rope/softmax/reshape are dropped (they
    are O(B·H·S·dh), two orders below the S² terms at planner scales)."""
    return 2.0 * batch * cfg.num_heads * float(seq) * seq * \
        cfg.resolved_head_dim
