"""FLOP counts the period planner reads. Counterpart of the part of
``repro/models/counting.py`` that the period planner uses; the parameter
count lives on :meth:`repro_torch.configs.base.ArchConfig.param_count`."""
from __future__ import annotations


def attention_core_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one block's attention core (QK^T logits + softmax·V), the
    planner ``comp_hints`` source: 2 matmuls of 2·B·H·S²·dh each, halved by
    the causal mask → 2·B·H·S²·dh. Rope/softmax/reshape are dropped (they
    are O(B·H·S·dh), two orders below the S² terms at planner scales)."""
    return 2.0 * batch * cfg.num_heads * float(seq) * seq * \
        cfg.resolved_head_dim


def expert_ffn_flops(cfg, batch: int, seq: int) -> float:
    """FLOPs of one MoE block's routed expert compute (the ``b{i}.eout``
    ``a2a_ffn`` node), the second planner ``comp_hints`` source: the
    dispatch buffers carry ``E·cap`` padded rows with
    ``cap = B·S·top_k·capacity_factor / E``, and every row runs the
    up+gate+down expert GEMMs at 2·d·d_ff each (every ported FFN is gated).
    Router and dispatch/combine einsums are dropped (O(T·E·cap), below the
    d·d_ff terms at planner scales). Returns 0 for dense configs."""
    m = cfg.moe
    if m is None:
        return 0.0
    rows = batch * float(seq) * m.top_k * m.capacity_factor
    return rows * 3 * 2.0 * cfg.d_model * cfg.d_ff
