"""GQA/MQA/sliding-window attention: the whole-sequence forward and the
paged serving path of ``repro/models/attention.py``.

The attention core dispatches through :mod:`repro_torch.kernels.ops`: the
Hopper flash-attention kernel for CUDA tensors, its plain PyTorch version for
CPU tensors.

Departure from the JAX package: :func:`paged_update` writes the new K/V into
the pools IN PLACE (``index_copy_``) instead of returning updated copies, so
a serving step never holds two versions of a pool.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init_

Pool = Dict[str, torch.Tensor]   # {"k", "v"}: (num_blocks, block_size, Hkv, dh)


class KVView(NamedTuple):
    """The seam between the serving layer and the model: where a mixed
    prefill+decode step's tokens live in the paged KV pools
    (``docs/serving.md``). All tensors lie on the model's device.

    ``block_tables[b, j]`` is the physical block holding request ``b``'s
    logical block ``j`` (padding rows/slots carry block 0 — their reads are
    masked by ``context_lens``). ``positions[b, s]`` is the absolute
    position of new token ``s`` of row ``b`` (−1 = padding: the token is
    neither written to the pool nor allowed to produce output).
    ``context_lens[b]`` counts the KV entries visible to row ``b`` AFTER
    this step's writes. ``last[b]`` indexes the row's last valid new token
    (0 for padding rows), where the step reads its logits."""

    block_tables: torch.Tensor   # (B, MAX_BLOCKS) int32
    positions: torch.Tensor      # (B, S_step) int32, −1 = padding
    context_lens: torch.Tensor   # (B,) int32
    last: torch.Tensor           # (B,) int32


def init_kv_pool(cfg: ArchConfig, num_blocks: int, block_size: int,
                 dtype: torch.dtype, device: torch.device) -> Pool:
    """One layer's paged KV pool: ``num_blocks`` fixed-size blocks shared by
    every request."""
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_update(kp: torch.Tensor, vp: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, block_tables: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write this step's K/V into the pools through the block tables, in
    place. kp/vp: (NB, BS, Hkv, dh); k_new/v_new: (B, S, Hkv, dh);
    positions: (B, S) absolute, −1 = padding (not written). Distinct
    requests own distinct blocks and prefix-shared blocks are never written
    (reuse is capped below the first fed position), so no two tokens land on
    one slot. Returns the same (updated) pools."""
    NB, BS = kp.shape[0], kp.shape[1]
    rows, cols = torch.nonzero(positions >= 0, as_tuple=True)
    pos = positions[rows, cols].long()
    blk = block_tables[rows, pos // BS].long()
    flat = blk * BS + pos % BS
    tail = kp.shape[2:]
    kp.view(NB * BS, *tail).index_copy_(0, flat, k_new[rows, cols])
    vp.view(NB * BS, *tail).index_copy_(0, flat, v_new[rows, cols])
    return kp, vp


def paged_lookup(kp: torch.Tensor, vp: torch.Tensor,
                 block_tables: torch.Tensor, context_lens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gather each row's KV context from the pools: returns (k, v,
    kv_positions) with k/v (B, MAXB·BS, Hkv, dh) and int32 kv_positions
    (B, MAXB·BS), −1 beyond the row's context."""
    B, MAXB = block_tables.shape
    BS = kp.shape[1]
    bt = block_tables.long()
    k = kp[bt].reshape(B, MAXB * BS, *kp.shape[2:])
    v = vp[bt].reshape(B, MAXB * BS, *vp.shape[2:])
    base = torch.arange(MAXB * BS, dtype=torch.int32,
                        device=kp.device)[None, :]
    return k, v, torch.where(base < context_lens[:, None], base, -1)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   causal: bool = True, window: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,Hkv,dh); key j is visible to query i iff
    kv_pos[j] >= 0 and, when causal, kv_pos[j] <= q_pos[i] and (window 0 or)
    kv_pos[j] > q_pos[i] - window. A query with no visible key yields zeros
    (JAX's finite mask gives the mean of v there; such rows are padding and
    reach neither a logit nor the pool)."""
    return ops.flash_attention(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, causal=causal,
                               window=window, scale=scale)


class Attention(nn.Module):
    """GQA/MQA projections: wq (d, H·dh), wk/wv (d, Hkv·dh), wo (H·dh, d).
    On a TP ring of ``tp`` ranks the module holds one rank's shards: wq and
    wk/wv by columns (wk/wv whole when ``Hkv % tp != 0``), wo by rows
    (:func:`repro_torch.core.tp.param_shard_dim`)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, tp: int = 1):
        super().__init__()
        d, H = cfg.d_model, cfg.num_heads
        Hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
        kv_tp = tp if Hkv % tp == 0 else 1
        mk = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        self.wq = mk(d, H * dh // tp)
        self.wk = mk(d, Hkv * dh // kv_tp)
        self.wv = mk(d, Hkv * dh // kv_tp)
        self.wo = mk(H * dh // tp, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)


def _project_qkv(params: Attention, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, dtype: torch.dtype):
    B, S, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ params.wq.to(dtype)).reshape(B, S, H, dh)
    k = (x @ params.wk.to(dtype)).reshape(B, S, Hkv, dh)
    v = (x @ params.wv.to(dtype)).reshape(B, S, Hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(params: Attention, x: torch.Tensor, cfg: ArchConfig,
                      *, window: int = 0, prefix_len: int = 0,
                      positions: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Training / prefill forward over a whole sequence, no cache.
    x: (B, S, d); positions default to 0..S-1."""
    if prefix_len:
        raise NotImplementedError("prefix-LM attention is not ported yet "
                                  "(VLM family, ROADMAP A15)")
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        positions = positions.expand(B, S).contiguous()
    q, k, v = _project_qkv(params, x, cfg, positions, x.dtype)
    o = attention_core(q, k, v, q_positions=positions,
                       kv_positions=positions, causal=True, window=window)
    return o.reshape(B, S, -1) @ params.wo.to(x.dtype)


def attention_paged(params: Attention, x: torch.Tensor, pool: Pool,
                    view: KVView, cfg: ArchConfig, *,
                    window: int = 0) -> Tuple[torch.Tensor, Pool]:
    """One mixed prefill/decode step against a paged pool: project the new
    tokens, write them through the block tables, attend over each row's
    gathered context. x: (B, S_step, d). Returns (out, pool), the pool
    updated in place."""
    B, S, _ = x.shape
    dtype = x.dtype
    q, k, v = _project_qkv(params, x, cfg, view.positions.clamp_min(0), dtype)
    paged_update(pool["k"], pool["v"], k, v, view.block_tables,
                 view.positions)
    kk, vv, kv_pos = paged_lookup(pool["k"], pool["v"], view.block_tables,
                                  view.context_lens)
    o = attention_core(q, kk, vv, q_positions=view.positions,
                       kv_positions=kv_pos, causal=True, window=window)
    return o.reshape(B, S, -1) @ params.wo.to(dtype), pool
