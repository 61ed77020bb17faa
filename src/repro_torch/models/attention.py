"""Attention blocks of ``repro/models/attention.py``: GQA/MQA/sliding-window
attention (the whole-sequence forward, dense and ring-buffer caches for
prefill + decode, the paged serving path) and MLA (multi-head latent
attention: forward, latent cache, absorbed decode).

The attention core dispatches through :mod:`repro_torch.kernels.ops`: the
Hopper flash-attention kernel for CUDA tensors, its plain PyTorch version for
CPU tensors. MLA's two latent norms (``rmsnorm(x @ w)`` for the query and
the KV latent) go through ``ops.matmul_rmsnorm`` the same way.

Caches:
  * dense: ``k``/``v`` ``(B, S_max, Hkv, dh)``; the decode position is
    passed as ``idx (B,)``.
  * swa: ring buffer ``(B, window, Hkv, dh)`` + absolute positions
    ``kpos (B, window)`` (−1 = empty); rope is applied at write time.
  * mla: latent ``c_kv (B, S_max, kv_rank)`` + the shared rope key
    ``k_rope (B, S_max, rope_dim)``; decode runs the absorbed form.

Departures from the JAX package: the decode steps and :func:`paged_update`
write the new K/V (or latents) into their caches and pools IN PLACE
(``index_put_``/``index_copy_``) instead of returning updated copies, so a
step never holds two versions of a cache; the returned cache is the same
dict.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init_

Pool = Dict[str, torch.Tensor]   # {"k", "v"}: (num_blocks, block_size, Hkv, dh)
Cache = Dict[str, torch.Tensor]  # one layer's dense, swa or mla cache
NEG_INF = -2.3819763e38          # finite, as in JAX: masked weights are exact 0


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
                 dtype: torch.dtype, device: torch.device, tp: int = 1
                 ) -> Pool:
    """One layer's paged KV pool: ``num_blocks`` fixed-size blocks shared by
    every request. On a TP ring of ``tp`` a rank holds its Hkv/tp kv heads
    when they shard, and all Hkv when they replicate (JAX's
    ``pool_pspec``)."""
    Hkv = cfg.num_kv_heads
    heads = Hkv // tp if Hkv % tp == 0 else Hkv
    shape = (num_blocks, block_size, heads, cfg.resolved_head_dim)
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
    """q (B,Sq,H,dh), k (B,Skv,Hkv,dh), v (B,Skv,Hkv,dv) -> (B,Sq,H,dv);
    key j is visible to query i iff
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


# ----- dense and sliding-window caches --------------------------------------


def init_dense_cache(cfg: ArchConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device) -> Cache:
    shape = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_swa_cache(cfg: ArchConfig, batch: int, window: int,
                   dtype: torch.dtype, device: torch.device) -> Cache:
    cache = init_dense_cache(cfg, batch, window, dtype, device)
    cache["kpos"] = torch.full((batch, window), -1, dtype=torch.int32,
                               device=device)
    return cache


def _write_at(buf: torch.Tensor, new: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """Per-request update in place: buf (B, S, ...) at row b, index idx[b],
    from new (B, 1, ...). Returns buf."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf.index_put_((rows, idx.long()), new[:, 0])


def _arange_positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device).expand(B, S).contiguous()


def attention_prefill(params: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                      window: int = 0, s_max: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """Forward over the prompt + the decode cache: the last ``window``
    keys in a ring buffer for a sliding-window layer, else all S keys in a
    dense cache of ``s_max`` slots. Returns (out, cache)."""
    B, S, _ = x.shape
    positions = _arange_positions(B, S, x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, x.dtype)
    o = attention_core(q, k, v, q_positions=positions, kv_positions=positions,
                       causal=True, window=window)
    out = o.reshape(B, S, -1) @ params.wo.to(x.dtype)
    if window:
        cache = init_swa_cache(cfg, B, window, x.dtype, x.device)
        take = min(S, window)
        pos = torch.arange(S - take, S, device=x.device)
        slots = pos % window
        cache["k"][:, slots] = k[:, S - take:]
        cache["v"][:, slots] = v[:, S - take:]
        cache["kpos"][:, slots] = pos.to(torch.int32)
    else:
        cache = init_dense_cache(cfg, B, s_max or S, x.dtype, x.device)
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return out, cache


def attention_decode(params: Attention, x: torch.Tensor, cache: Cache,
                     idx: torch.Tensor, cfg: ArchConfig, *,
                     window: int = 0) -> Tuple[torch.Tensor, Cache]:
    """One decode step. x: (B, 1, d); idx: (B,) int32 position of the new
    token. Writes its K/V into ``cache`` in place; returns (out, cache)."""
    B = x.shape[0]
    positions = idx[:, None].to(torch.int32).contiguous()
    q, k, v = _project_qkv(params, x, cfg, positions, x.dtype)
    if window:
        slot = idx.long() % cache["k"].shape[1]
        _write_at(cache["k"], k, slot)
        _write_at(cache["v"], v, slot)
        _write_at(cache["kpos"], positions, slot)
        kv_pos = cache["kpos"]
    else:
        _write_at(cache["k"], k, idx)
        _write_at(cache["v"], v, idx)
        base = _arange_positions(1, cache["k"].shape[1], x.device)
        kv_pos = torch.where(base <= positions, base, -1)
    o = attention_core(q, cache["k"], cache["v"], q_positions=positions,
                       kv_positions=kv_pos, causal=True, window=window)
    return o.reshape(B, 1, -1) @ params.wo.to(x.dtype), cache


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """MLA projections, JAX's names and shapes: wq_a (d, q_rank), q_norm
    (q_rank,), wq_b (q_rank, H·(nope+rope)), wkv_a (d, kv_rank + rope) (the
    KV latent and the shared rope key), kv_norm (kv_rank,), wk_b (kv_rank,
    H·nope), wv_b (kv_rank, H·v), wo (H·v, d). The norm scales start at 0
    (a ``(1 + 0)`` scale)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        mk = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        zeros = lambda n: nn.Parameter(
            torch.zeros(n, dtype=dtype, device=device), requires_grad=False)
        self.wq_a = mk(d, m.q_lora_rank)
        self.q_norm = zeros(m.q_lora_rank)
        self.wq_b = mk(m.q_lora_rank, H * qk)
        self.wkv_a = mk(d, m.kv_lora_rank + m.qk_rope_head_dim)
        self.kv_norm = zeros(m.kv_lora_rank)
        self.wk_b = mk(m.kv_lora_rank, H * m.qk_nope_head_dim)
        self.wv_b = mk(m.kv_lora_rank, H * m.v_head_dim)
        self.wo = mk(H * m.v_head_dim, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq_a, self.wq_b, self.wkv_a, self.wk_b, self.wv_b,
                  self.wo):
            dense_init_(w, generator)


def _mla_q(params: MLA, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, dtype: torch.dtype):
    """(q_nope, q_rope), each (B, S, H, ·), rope applied. The query latent
    ``rmsnorm(x @ wq_a)`` is one ``matmul_rmsnorm`` call on the (B·S, d)
    rows. It normalises the f32 product, where JAX rounds ``x @ wq_a`` to
    the compute type first: in bf16 the two differ by at most one bf16
    rounding before the norm; in f32 they are the same."""
    m = cfg.mla
    B, S, d = x.shape
    cq = ops.matmul_rmsnorm(x.reshape(B * S, d), params.wq_a.to(dtype),
                            params.q_norm, out_dtype=dtype)
    q = (cq @ params.wq_b.to(dtype)).reshape(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latents(params: MLA, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, dtype: torch.dtype):
    """(c_kv (B, S, kv_rank), k_rope (B, S, rope)). The KV latent
    ``rmsnorm(x @ wkv_a[:, :kv_rank])`` is one ``matmul_rmsnorm`` call on
    the column slice of wkv_a as it lies (row stride kv_rank + rope, no
    copy); the shared rope key is the plain product with the last rope
    columns, rotated as one head. The bf16 note of :func:`_mla_q`
    holds."""
    m = cfg.mla
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    wkv = params.wkv_a.to(dtype)
    c_kv = ops.matmul_rmsnorm(x2, wkv[:, :m.kv_lora_rank], params.kv_norm,
                              out_dtype=dtype)
    k_rope = (x2 @ wkv[:, m.kv_lora_rank:]).reshape(B, S, 1,
                                                     m.qk_rope_head_dim)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv.reshape(B, S, m.kv_lora_rank), k_rope


def _mla_attend(params: MLA, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor):
    """The MLA forward over a whole sequence; returns (out, c_kv, k_rope)
    so that a prefill caches the latents it computed (JAX computes them a
    second time; the values are the same)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dtype = x.dtype
    q_nope, q_rope = _mla_q(params, x, cfg, positions, dtype)
    c_kv, k_rope = _mla_latents(params, x, cfg, positions, dtype)
    k_nope = (c_kv @ params.wk_b.to(dtype)).reshape(B, S, H,
                                                    m.qk_nope_head_dim)
    v = (c_kv @ params.wv_b.to(dtype)).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], -1)
    o = attention_core(
        q, k, v, q_positions=positions, kv_positions=positions, causal=True,
        scale=1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim))
    return o.reshape(B, S, -1) @ params.wo.to(dtype), c_kv, k_rope


def mla_forward(params: MLA, x: torch.Tensor, cfg: ArchConfig,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill forward. x: (B, S, d); positions default to
    0..S-1."""
    B, S, _ = x.shape
    if positions is None:
        positions = _arange_positions(B, S, x.device)
    return _mla_attend(params, x, cfg, positions)[0]


def init_mla_cache(cfg: ArchConfig, batch: int, s_max: int,
                   dtype: torch.dtype, device: torch.device) -> Cache:
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, s_max, m.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, s_max, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(params: MLA, x: torch.Tensor, cfg: ArchConfig, *,
                s_max: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Forward over the prompt + the latent cache of ``s_max`` slots.
    Returns (out, cache)."""
    B, S, _ = x.shape
    out, c_kv, k_rope = _mla_attend(params, x, cfg,
                                    _arange_positions(B, S, x.device))
    cache = init_mla_cache(cfg, B, s_max or S, x.dtype, x.device)
    cache["c_kv"][:, :S] = c_kv
    cache["k_rope"][:, :S] = k_rope
    return out, cache


def mla_decode(params: MLA, x: torch.Tensor, cache: Cache, idx: torch.Tensor,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Cache]:
    """Absorbed-form decode: wk_b folds into the query and wv_b into the
    output, so attention runs in the kv_rank latent space, O(S·kv_rank) a
    step. The scores are f32 (JAX's ``preferred_element_type``), the
    probabilities cast to the compute type for the latent product. Writes
    the new latents into ``cache`` in place; returns (out, cache)."""
    m = cfg.mla
    B = x.shape[0]
    H = cfg.num_heads
    dtype = x.dtype
    positions = idx[:, None].to(torch.int32)
    q_nope, q_rope = _mla_q(params, x, cfg, positions, dtype)  # (B,1,H,·)
    c_new, kr_new = _mla_latents(params, x, cfg, positions, dtype)
    c_kv = _write_at(cache["c_kv"], c_new, idx)
    k_rope = _write_at(cache["k_rope"], kr_new, idx)
    wk_b = params.wk_b.to(dtype).reshape(m.kv_lora_rank, H,
                                         m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, wk_b)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    s = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), c_kv.float())
         + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), k_rope.float())
         ) * scale
    base = torch.arange(c_kv.shape[1], device=x.device)[None, :]
    valid = (base <= idx[:, None].long())[:, None, None, :]
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhqk,bkr->bqhr", p.to(dtype), c_kv)
    wv_b = params.wv_b.to(dtype).reshape(m.kv_lora_rank, H, m.v_head_dim)
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b)
    return o.reshape(B, 1, -1) @ params.wo.to(dtype), cache
