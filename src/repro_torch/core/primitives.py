"""CAIS core primitives: decomposed collective-fused GEMM schedules on a
:class:`repro_torch.sharding.TPGroup`.

Counterpart of ``repro/core/primitives.py``. The paper's insight:
communication follows the compute kernel's memory semantics, so data is
consumed and produced chunk by chunk with no global barrier between the
collective and the GEMM. On a ring that is a chain of point-to-point
permutes interleaved with partial GEMMs:

  * :func:`ag_gemm`   — pull-aligned AllGather→GEMM: each ring step's
    arriving activation chunk is consumed at once by a partial GEMM;
  * :func:`gemm_rs`   — push-aligned GEMM→ReduceScatter: a rotating
    accumulator is summed hop by hop (the ring is the merge unit);
  * :func:`gemm_ar`   — AR = RS + AG;
  * :func:`fused_rs_ln_ag` — GEMM-RS + LN + AG-GEMM in one pipeline;
  * :func:`overlap_asymmetric` — an independent GEMM-RS and AG-GEMM in
    lockstep on opposite ring directions;
  * :func:`a2a_expert_ffn` — the expert all-to-all (EP): per offset the
    dispatch permute of one chunk and the combine permute of the previous
    expert result travel opposite directions together, with the expert
    GEMMs between them, and :func:`grad_a2a_expert_ffn`, its adjoint;
  * ``barrier_*``     — the baselines: one monolithic collective around the
    GEMM.

Every function runs on one rank with its local shards (the JAX version ran
inside ``shard_map``). ``lax.scan`` over ring steps is a Python loop, and the
last step's permute, whose result JAX discards, is not issued. Every GEMM
goes through :func:`repro_torch.kernels.ops.matmul`: the Hopper kernel for
CUDA tensors, its plain version for CPU tensors. The results are placed by
origin shard directly; JAX reassembled them with a roll of the step axis,
which is the same permutation (at step t the forward ring holds the chunk of
rank i−t, the backward ring that of rank i+t).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.sharding import TPGroup

DEFAULT_NUM_CHUNKS = 4


@dataclass(frozen=True)
class CAISConfig:
    """Chunking knobs (see :mod:`repro_torch.core.coordination`).

    ``num_chunks=None`` leaves the chunking open: the ``cais`` backend then
    plans it per collective from payload bytes and ring size; primitives
    called directly fall back to ``DEFAULT_NUM_CHUNKS``. ``hw`` is the
    :class:`repro_torch.hw.HWSpec` the planner plans against (``None`` →
    H100). JAX's ``interpret_n`` (a ring-size override for tests) has no
    counterpart: the ring size is the group's."""

    num_chunks: Optional[int] = None   # micro-chunks per local shard
    bidirectional: bool = True         # use both ring directions
    hw: Optional[object] = None        # repro_torch.hw.HWSpec


def _ring_perms(n: int, direction: int) -> Sequence[Tuple[int, int]]:
    if direction > 0:
        return [(i, (i + 1) % n) for i in range(n)]
    return [(i, (i - 1) % n) for i in range(n)]


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) through the matmul kernel: the leading dims fold
    into the kernel's rows (a non-contiguous slice is copied once here). A
    2-D ``x`` that is the transpose of a contiguous tensor (the backward's
    xᵀ), and a ``w`` that is one (the backward's wᵀ), pass as they lie."""
    K, N = w.shape
    a = x.reshape(-1, K)
    if not (a.is_contiguous() or (x.dim() == 2 and a.T.is_contiguous())):
        a = a.contiguous()
    out = ops.matmul(a, w)
    return out.reshape(*x.shape[:-1], N)


def _rows(x: torch.Tensor, start: int, length: int) -> torch.Tensor:
    return x[:, start:start + length]


# ---------------------------------------------------------------------------
# Barrier baselines — one opaque collective around the GEMM
# ---------------------------------------------------------------------------


def barrier_ag_gemm(x: torch.Tensor, w: torch.Tensor,
                    group: TPGroup) -> torch.Tensor:
    """x: (B, S_loc, d) seq-sharded; w: (d, F_loc). Returns (B, S, F_loc);
    the all-gather completes before the GEMM starts."""
    return mm(group.all_gather(x, 1), w)


def barrier_gemm_rs(x: torch.Tensor, w: torch.Tensor,
                    group: TPGroup) -> torch.Tensor:
    """x: (B, S, d_loc) feature-sharded; w: (d_loc, F). Returns (B, S_loc,
    F) reduced over the group and scattered on S."""
    return group.reduce_scatter(mm(x, w), 1)


def barrier_gemm_ar(x: torch.Tensor, w: torch.Tensor,
                    group: TPGroup) -> torch.Tensor:
    """Basic-TP row-parallel GEMM + AllReduce."""
    return group.all_reduce(mm(x, w))


# ---------------------------------------------------------------------------
# CAIS AG-GEMM: pull-aligned decomposed all-gather matmul
# ---------------------------------------------------------------------------


def ag_gemm_multi(x: torch.Tensor, ws: Sequence[torch.Tensor],
                  group: TPGroup, cais: CAISConfig = CAISConfig()
                  ) -> Tuple[torch.Tensor, ...]:
    """Decomposed AllGather→GEMM against several weights sharing one gather
    (QKV, gate+up: the activation circulates once, every weight consumes
    each chunk).

    x: (B, S_loc, d) sequence-sharded; ws[k]: (d, F_k_loc) column-sharded.
    Returns one (B, S_loc·n, F_k_loc) per weight, identical to
    ``barrier_ag_gemm`` per weight. The local shard is cut into ``c``
    micro-chunks; the first half travels the +1 ring, the rest the −1 ring
    (``bidirectional``)."""
    n = group.size
    if n == 1:
        return tuple(mm(x, w) for w in ws)
    B, S_loc, _ = x.shape
    i = group.rank
    c = _pick_chunks(S_loc, cais.num_chunks)
    half = c // 2 if (cais.bidirectional and c >= 2) else c
    s = S_loc // c
    fwd, bwd = _ring_perms(n, +1), _ring_perms(n, -1)
    perms = [fwd if j < half else bwd for j in range(c)]
    outs = [x.new_empty((B, n * S_loc, w.shape[1])) for w in ws]
    chunks = [_rows(x, j * s, s) for j in range(c)]
    for t in range(n):
        for j, chunk in enumerate(chunks):
            src = (i - t) % n if j < half else (i + t) % n
            for out, w in zip(outs, ws):
                _rows(out, src * S_loc + j * s, s).copy_(mm(chunk, w))
        if t < n - 1:
            chunks = group.ppermute_many(chunks, perms)
    return tuple(outs)


def ag_gemm(x: torch.Tensor, w: torch.Tensor, group: TPGroup,
            cais: CAISConfig = CAISConfig()) -> torch.Tensor:
    """Decomposed AllGather→GEMM (single weight). See :func:`ag_gemm_multi`."""
    return ag_gemm_multi(x, (w,), group, cais)[0]


def _pick_chunks(s_loc: int, requested: Optional[int]) -> int:
    if requested is None:
        requested = DEFAULT_NUM_CHUNKS
    c = max(1, min(requested, s_loc))
    while s_loc % c:
        c -= 1
    return c


# ---------------------------------------------------------------------------
# CAIS GEMM-RS: push-aligned decomposed matmul reduce-scatter
# ---------------------------------------------------------------------------


def _reduce_ring(part, n: int, i: int, S_loc: int, group: TPGroup,
                 bidirectional: bool) -> torch.Tensor:
    """The rotating-accumulator ring shared by :func:`gemm_rs` and
    :func:`ring_reduce_scatter`: ``part(j, lo, ln)`` is this rank's
    contribution to rows ``lo:lo+ln`` of destination shard ``j``. With
    ``bidirectional`` (even ring and even S_loc) the two row halves reduce
    around opposite rings; otherwise (odd S_loc, e.g. S_loc == 1 at S == n)
    one ring carries the whole shard."""
    fwd, bwd = _ring_perms(n, +1), _ring_perms(n, -1)
    if bidirectional and n % 2 == 0 and S_loc % 2 == 0:
        h = S_loc // 2
        accf, accb = part((i - 1) % n, 0, h), part((i + 1) % n, h, h)
        for t in range(1, n):
            accf, accb = group.ppermute_many([accf, accb], [fwd, bwd])
            accf = accf + part((i - 1 - t) % n, 0, h)    # shard i−1−t
            accb = accb + part((i + 1 + t) % n, h, h)    # shard i+1+t
        return torch.cat([accf, accb], dim=1)
    acc = part((i - 1) % n, 0, S_loc)
    for t in range(1, n):
        acc = group.ppermute(acc, fwd) + part((i - 1 - t) % n, 0, S_loc)
    return acc


def gemm_rs(x: torch.Tensor, w: torch.Tensor, group: TPGroup,
            cais: CAISConfig = CAISConfig()) -> torch.Tensor:
    """Decomposed GEMM→ReduceScatter.

    x: (B, S, d_loc) feature-sharded; w: (d_loc, F) row-sharded. Returns
    (B, S_loc, F), identical to ``barrier_gemm_rs``, with each destination
    shard's partial GEMM computed just in time as the rotating accumulator
    arrives."""
    n = group.size
    if n == 1:
        return mm(x, w)
    S_loc = x.shape[1] // n
    return _reduce_ring(
        lambda j, lo, ln: mm(_rows(x, j * S_loc + lo, ln), w),
        n, group.rank, S_loc, group, cais.bidirectional)


def gemm_ar(x: torch.Tensor, w: torch.Tensor, group: TPGroup,
            cais: CAISConfig = CAISConfig()) -> torch.Tensor:
    """Basic-TP GEMM→AllReduce as RS + AG (both decomposed).
    x: (B, S, d_loc); w: (d_loc, F). Returns (B, S, F) fully reduced."""
    if group.size == 1:
        return mm(x, w)
    return ring_all_gather(gemm_rs(x, w, group, cais), group, cais)


def ring_all_gather(x: torch.Tensor, group: TPGroup,
                    cais: CAISConfig = CAISConfig()) -> torch.Tensor:
    """Decomposed (bidirectional) ring all-gather along dim 1."""
    n = group.size
    if n == 1:
        return x
    i = group.rank
    B, S_loc = x.shape[0], x.shape[1]
    out = x.new_empty((B, n * S_loc, *x.shape[2:]))
    fwd, bwd = _ring_perms(n, +1), _ring_perms(n, -1)
    if cais.bidirectional and S_loc >= 2:
        h = S_loc // 2
        parts, perms = [x[:, :h], x[:, h:]], [fwd, bwd]
        spans = [(0, h), (h, S_loc - h)]
        for t in range(n):
            srcs = [(i - t) % n, (i + t) % n]
            for part, src, (lo, ln) in zip(parts, srcs, spans):
                _rows(out, src * S_loc + lo, ln).copy_(part)
            if t < n - 1:
                parts = group.ppermute_many(parts, perms)
        return out
    part = x
    for t in range(n):
        _rows(out, ((i - t) % n) * S_loc, S_loc).copy_(part)
        if t < n - 1:
            part = group.ppermute(part, fwd)
    return out


def ring_reduce_scatter(x: torch.Tensor, group: TPGroup,
                        cais: CAISConfig = CAISConfig()) -> torch.Tensor:
    """Decomposed (bidirectional) ring reduce-scatter along dim 1 — the
    standalone counterpart of :func:`gemm_rs`'s rotating accumulator."""
    n = group.size
    if n == 1:
        return x
    S_loc = x.shape[1] // n
    return _reduce_ring(lambda j, lo, ln: _rows(x, j * S_loc + lo, ln),
                        n, group.rank, S_loc, group, cais.bidirectional)


# ---------------------------------------------------------------------------
# CAIS expert all-to-all: decomposed dispatch/compute/combine pipeline (EP)
# ---------------------------------------------------------------------------


def barrier_a2a_expert_ffn(send: torch.Tensor, ffn, group: TPGroup
                           ) -> torch.Tensor:
    """EP baseline: monolithic dispatch all-to-all → expert FFN → combine
    all-to-all (three isolated phases).

    send: (n, C, d), ``send[j]`` this rank's tokens routed to the experts
    rank j owns; ffn: (C, d) -> (C, d), this rank's experts. Returns
    (n, C, d): ``out[j] = FFN_j(send[j])`` (owner j's experts applied)."""
    recv = group.all_to_all(send)
    h = torch.stack([ffn(row) for row in recv])
    return group.all_to_all(h)


def _a2a_offset(o: int, bidirectional: bool) -> int:
    """The ring offset of step ``o`` (1..n-1): o, or alternating
    +1, −1, +2, −2, … so that consecutive dispatches balance the two
    directions."""
    if not bidirectional:
        return o
    return (o + 1) // 2 if o % 2 else -(o // 2)


def _offset_perm(n: int, offset: int) -> Sequence[Tuple[int, int]]:
    return [(s, (s + offset) % n) for s in range(n)]


def a2a_expert_ffn(send: torch.Tensor, ffn, group: TPGroup,
                   cais: CAISConfig = CAISConfig()) -> torch.Tensor:
    """CAIS-decomposed expert all-to-all; same contract as
    :func:`barrier_a2a_expert_ffn`.

    The local chunk computes at once (no wire). Then per offset o = 1..n−1
    one ``batch_isend_irecv`` carries the dispatch of chunk o (+off) and the
    combine of the previous offset's expert result back to its sender
    (−off, the opposite direction), and the expert FFN runs on the chunk
    that arrived: dispatch and combine occupy opposite link directions every
    step, the asymmetric overlap of paper Fig. 9e applied to EP. JAX issues
    the two permutes of an offset in one step and lets XLA overlap the
    combine with the next dispatch; here that pairing is explicit, and the
    last combine goes alone."""
    n = group.size
    if n == 1:
        return torch.stack([ffn(row) for row in send])
    i = group.rank
    results = torch.empty_like(send)
    results[i] = ffn(send[i])
    pending = None          # (expert result, its offset, its origin row)
    for o in range(1, n):
        off = _a2a_offset(o, cais.bidirectional)
        dst = (i + off) % n
        xs, perms = [send[dst]], [_offset_perm(n, off)]
        if pending is not None:
            xs.append(pending[0])
            perms.append(_offset_perm(n, -pending[1]))
        got = group.ppermute_many(xs, perms)
        if pending is not None:
            results[pending[2]] = got[1]     # my tokens, from rank (i+off')
        pending = (ffn(got[0]), off, dst)    # owner-i experts on (i−off)'s
    results[pending[2]] = group.ppermute(pending[0],
                                         _offset_perm(n, -pending[1]))
    return results


def grad_a2a_expert_ffn(send: torch.Tensor, gy: torch.Tensor, bwd_row,
                        group: TPGroup, cais: CAISConfig = CAISConfig()):
    """CAIS-decomposed adjoint of :func:`a2a_expert_ffn`, interleaved as the
    forward: per offset the grad dispatch (+off) carries the (send row,
    output cotangent row) pair to the owning expert, the per-row expert VJP
    runs on the pair that arrived, and the chunk cotangent of the previous
    offset returns to its sender (−off) in the same batch.

    ``bwd_row(chunk, gy_row) -> (d_chunk, dw_tuple)`` is the per-row expert
    VJP, returning fresh grads. Expert weight grads accumulate (in place)
    at the owner and never ride a collective. Returns ``(d_send, dw_tuple)``, ``d_send`` shaped like
    ``send``."""
    n = group.size
    if n == 1:
        return rows_vjp(send, gy, bwd_row)
    i = group.rank
    d0, dws = bwd_row(send[i], gy[i])
    d_send = torch.empty_like(send)
    d_send[i] = d0
    pending = None
    for o in range(1, n):
        off = _a2a_offset(o, cais.bidirectional)
        dst = (i + off) % n
        perm = _offset_perm(n, off)
        xs, perms = [send[dst], gy[dst]], [perm, perm]
        if pending is not None:
            xs.append(pending[0])
            perms.append(_offset_perm(n, -pending[1]))
        got = group.ppermute_many(xs, perms)
        if pending is not None:
            d_send[pending[2]] = got[2]
        d_chunk, dw_o = bwd_row(got[0], got[1])      # my experts' VJP
        for acc, dw in zip(dws, dw_o):
            acc.add_(dw)
        pending = (d_chunk, off, dst)
    d_send[pending[2]] = group.ppermute(pending[0],
                                        _offset_perm(n, -pending[1]))
    return d_send, dws


def rows_vjp(send: torch.Tensor, gy: torch.Tensor, bwd_row):
    """``bwd_row`` over every row (JAX's ``vmap``), the weight grads summed
    over the rows in place: (d_send, dw_tuple). ``bwd_row`` returns fresh
    grads, so the first row's accumulate the rest."""
    d_rows, dws = [], None
    for c, g in zip(send, gy):
        d, dw = bwd_row(c, g)
        d_rows.append(d)
        if dws is None:
            dws = dw
        else:
            for acc, w in zip(dws, dw):
                acc.add_(w)
    return torch.stack(d_rows), dws


# ---------------------------------------------------------------------------
# Fused sub-layer: GEMM-RS + LN + AG-GEMM (the paper's L1–L4 chain)
# ---------------------------------------------------------------------------


def fused_rs_ln_ag(x: torch.Tensor, w1: torch.Tensor, ln_scale: torch.Tensor,
                   w2: torch.Tensor, group: TPGroup,
                   cais: CAISConfig = CAISConfig(), norm: str = "rmsnorm",
                   residual: Optional[torch.Tensor] = None):
    """x: (B, S, d1_loc) feature-sharded → GEMM-RS → (B, S_loc, d)
    → (+residual) → LN (sequence-parallel, no collective) → AG-GEMM →
    (B, S, d2_loc). Returns (out, z), z the post-residual value."""
    from repro_torch.models.layers import apply_norm  # no import cycle

    z = gemm_rs(x, w1, group, cais)
    if residual is not None:
        z = z + residual
    zn = apply_norm(norm, z, ln_scale)
    return ag_gemm(zn, w2, group, cais), z


# ---------------------------------------------------------------------------
# Asymmetric dual-stream overlap: two independent chains, opposite traffic
# ---------------------------------------------------------------------------


def overlap_asymmetric(rs_args, ag_args, group: TPGroup,
                       cais: CAISConfig = CAISConfig()):
    """An independent GEMM-RS and AG-GEMM in lockstep: each step issues one
    RS hop (+1 ring) and one AG hop (−1 ring), in one batch, plus both
    partial GEMMs.

    rs_args: (x_rs (B,S,d_loc), w_rs (d_loc,F)); ag_args: (x_ag
    (B,S_loc,d), w_ag (d,F_loc) — or a tuple of such weights sharing the one
    AG circulation). Returns (rs_out (B,S_loc,F), ag_out (B,S,F_loc)), with
    ``ag_out`` a tuple of per-weight outputs when ``w_ag`` is a tuple."""
    x_rs, w_rs = rs_args
    x_ag, w_ag = ag_args
    multi = isinstance(w_ag, (tuple, list))
    ws_ag = tuple(w_ag) if multi else (w_ag,)
    n = group.size
    if n == 1:
        outs = tuple(mm(x_ag, w) for w in ws_ag)
        return mm(x_rs, w_rs), (outs if multi else outs[0])
    i = group.rank
    S_loc = x_rs.shape[1] // n
    B, s_ag = x_ag.shape[0], x_ag.shape[1]
    fwd, bwd = _ring_perms(n, +1), _ring_perms(n, -1)

    def rs_partial(j):
        return mm(_rows(x_rs, j * S_loc, S_loc), w_rs)

    ag_outs: List[torch.Tensor] = [x_ag.new_empty((B, n * s_ag, w.shape[1]))
                                   for w in ws_ag]

    def ag_partial(chunk, src):
        for out, w in zip(ag_outs, ws_ag):
            _rows(out, src * s_ag, s_ag).copy_(mm(chunk, w))

    acc = rs_partial((i - 1) % n)
    ag_partial(x_ag, i)
    chunk = x_ag
    for t in range(1, n):
        acc, chunk = group.ppermute_many([acc, chunk], [fwd, bwd])
        acc = acc + rs_partial((i - 1 - t) % n)
        ag_partial(chunk, (i + t) % n)      # the −1 ring brings rank i+t's
    return acc, (tuple(ag_outs) if multi else ag_outs[0])
