"""CollectiveBackend: the registry-dispatched TP execution API.

Counterpart of ``repro/core/backends.py``. Every collective-fused schedule
the model path can run — AG→GEMM, GEMM→RS, GEMM→AR, the fused RS+LN+AG
sub-layer chain and the asymmetric dual-stream overlap — is reached through
one seam: a :class:`CollectiveBackend` instance looked up by name.
:mod:`repro_torch.core.tp` and :func:`repro_torch.core.dataflow.execute`
dispatch through it instead of branching on mode strings.

Built-in backends: ``barrier`` (one monolithic collective around each
GEMM), ``cais`` (the paper's decomposed ring schedules of
:mod:`repro_torch.core.primitives`, with the chunking planned per collective
by :func:`repro_torch.core.coordination.plan` unless
``CAISConfig.num_chunks`` pins it) and ``auto`` (``explicit = False``: in
JAX the compiler schedules TP from sharding constraints; in torch the model
path runs its one-device code on DTensors, whose sharding propagation
chooses the collectives: :mod:`repro_torch.models.transformer`, for dense
attention blocks; every other block kind raises under it on a group,
ROADMAP A5 (b)).

Methods run on one rank with its local shards and take the
:class:`repro_torch.sharding.TPGroup` where JAX took the axis name. The
backward collectives ``grad_ag_gemm`` and ``grad_a2a_expert_ffn`` (the
``bwd_ag_gemm`` and ``bwd_a2a_ffn`` IR ops of a training graph) are here.

On a 2D mesh the group is a :class:`repro_torch.sharding.CompositeGroup`
(JAX's ``("tp_in", "tp_out")`` axis tuple) and every public method
dispatches to its ``hier_*`` composition, as JAX's do: the inter-node legs
run through the ``_outer_*`` hooks (monolithic on ``barrier``;
ring-decomposed and chunk-planned against ``hw.inter_tier()`` on ``cais``)
and the backend's own fused schedules run on the intra-node ring
(``group.tp_in``). AG gathers the outer axis first, so its concatenation is
this node's contiguous block; RS scatters the inner axis first
(docs/topology.md). The expert all-to-all of grouped EP and its adjoint
run on ``group.tp_out`` only.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import coordination
from repro_torch.core import primitives as prim
from repro_torch.core.primitives import CAISConfig
from repro_torch.hw import H100
from repro_torch.sharding import CompositeGroup, TPGroup


class CollectiveBackend:
    """Protocol for TP collective-fused execution strategies. Subclasses
    implement ``ag_gemm_multi``, ``gemm_rs`` and ``overlap_asymmetric``;
    ``gemm_ar`` and the fused chains compose from them by default."""

    name: str = "abstract"
    explicit: bool = True

    # -- AG-aligned -------------------------------------------------------
    def ag_gemm(self, x, w, group: TPGroup, cais: CAISConfig):
        """(B, S_loc, d) seq-sharded x; (d, F_loc) w -> (B, S, F_loc)."""
        return self.ag_gemm_multi(x, (w,), group, cais)[0]

    def ag_gemm_multi(self, x, ws: Sequence, group: TPGroup,
                      cais: CAISConfig) -> Tuple[torch.Tensor, ...]:
        """One gather shared by several column-sharded weights."""
        raise NotImplementedError

    # -- RS/AR-aligned ----------------------------------------------------
    def gemm_rs(self, x, w, group: TPGroup, cais: CAISConfig):
        """(B, S, d_loc) feat-sharded x; (d_loc, F) w -> (B, S_loc, F)."""
        raise NotImplementedError

    def gemm_ar(self, x, w, group: TPGroup, cais: CAISConfig):
        """(B, S, d_loc) x; (d_loc, F) w -> (B, S, F) reduced. Default:
        AR = RS + AG from the backend's own ``gemm_rs``; a monolithic
        allreduce where the sequence cannot scatter over the ring."""
        if int(x.shape[1]) % max(group.size, 1) != 0:
            return prim.barrier_gemm_ar(x, w, group)
        return group.all_gather(self.gemm_rs(x, w, group, cais), 1)

    # -- EP ---------------------------------------------------------------
    def a2a_expert_ffn(self, send, ffn, group: TPGroup, cais: CAISConfig):
        """(n, C, d) routed chunks -> (n, C, d) expert outputs (see
        :func:`repro_torch.core.primitives.a2a_expert_ffn`)."""
        raise NotImplementedError

    # -- fused sub-layer chain -------------------------------------------
    def fused_rs_ln_ag(self, x, w1, ln_scale, w2, group: TPGroup,
                       cais: CAISConfig, norm: str = "rmsnorm",
                       residual=None):
        """GEMM-RS -> (+res) -> LN -> AG-GEMM. Returns (out, z)."""
        outs, z = self.fused_rs_ln_ag_multi(x, w1, ln_scale, (w2,), group,
                                            cais, norm=norm,
                                            residual=residual)
        return outs[0], z

    def fused_rs_ln_ag_multi(self, x, w1, ln_scale, ws2: Sequence,
                             group: TPGroup, cais: CAISConfig,
                             norm: str = "rmsnorm", residual=None):
        """GEMM-RS -> (+res) -> LN -> shared-gather AG-GEMM against several
        weights. Returns (per-weight outputs tuple, z). Composed from the
        backend's own ``gemm_rs`` / ``ag_gemm_multi``."""
        from repro_torch.models.layers import apply_norm

        z = self.gemm_rs(x, w1, group, cais)
        if residual is not None:
            z = z + residual
        zn = apply_norm(norm, z, ln_scale)
        return self.ag_gemm_multi(zn, tuple(ws2), group, cais), z

    def fused_rs_ln(self, x, w1, ln_scale, group: TPGroup, cais: CAISConfig,
                    norm: str = "rmsnorm", residual=None):
        """GEMM-RS -> (+res) -> LN with no trailing gather (the MoE router
        seam). Returns (normed, z)."""
        from repro_torch.models.layers import apply_norm

        z = self.gemm_rs(x, w1, group, cais)
        if residual is not None:
            z = z + residual
        return apply_norm(norm, z, ln_scale), z

    # -- asymmetric dual-stream overlap ----------------------------------
    def overlap_asymmetric(self, rs_args, ag_args, group: TPGroup,
                           cais: CAISConfig):
        """Independent GEMM-RS + AG-GEMM pair; the AG side's weight may be a
        tuple. Returns (rs_out, ag_out[s])."""
        raise NotImplementedError

    # -- backward collectives (training graphs) ----------------------------
    def grad_ag_gemm(self, d, wT, group: TPGroup, cais: CAISConfig):
        """Adjoint of ``gemm_rs`` (the ``bwd_ag_gemm`` IR op): all-gather the
        seq-sharded output cotangent ``d`` (B, S_loc, F) and GEMM it with
        the transposed local weight shard ``wT`` (F, d_loc), a view.
        Returns ``(d @ wT gathered, d gathered)``: the second feeds the
        weight-gradient GEMM, so the gather runs once. Default: one
        monolithic all-gather (the barrier schedule)."""
        if self.hierarchical(group):
            return self.hier_grad_ag_gemm(d, wT, group, cais)
        g = group.all_gather(d, 1)
        return prim.mm(g, wT), g

    def grad_a2a_expert_ffn(self, send, gy, bwd_row, group: TPGroup,
                            cais: CAISConfig):
        """Adjoint of ``a2a_expert_ffn`` (the ``bwd_a2a_ffn`` IR op):
        re-run the dispatch all-to-all for ``send`` and for the output
        cotangent ``gy`` (the forward's routed chunks are not stashed),
        apply the per-row expert VJP ``bwd_row(chunk, gy_row) -> (d_chunk,
        dw_tuple)`` at the owning rank, then all-to-all the chunk
        cotangents back to their senders. Expert weight grads stay at the
        owner, summed over the arriving rows. Default: monolithic
        all-to-alls (the barrier schedule)."""
        if self.hierarchical(group):
            return self.hier_grad_a2a_expert_ffn(send, gy, bwd_row, group,
                                                 cais)
        if group.size == 1:
            return prim.rows_vjp(send, gy, bwd_row)
        d_rows, dws = prim.rows_vjp(group.all_to_all(send),
                                     group.all_to_all(gy), bwd_row)
        return group.all_to_all(d_rows), dws

    # -- hierarchical (2D-mesh) compositions -------------------------------
    # ``group`` is a CompositeGroup: ``group.tp_in`` the fast tp_in ring,
    # ``group.tp_out`` the slow tp_out one (the composite index is tp_in
    # major, so the outer index is minor)

    @staticmethod
    def hierarchical(group) -> bool:
        """True when ``group`` is a 2D mesh's composite TP group."""
        return isinstance(group, CompositeGroup)

    def _inner_all_gather(self, x, group: TPGroup, cais: CAISConfig):
        """Intra-node all-gather leg (dim 1) of hierarchical AR."""
        return group.all_gather(x, 1)

    def _outer_all_gather(self, x, group: TPGroup, cais: CAISConfig):
        """Inter-node all-gather leg (dim 1)."""
        return group.all_gather(x, 1)

    def _outer_reduce_scatter(self, x, group: TPGroup, cais: CAISConfig):
        """Inter-node reduce-scatter leg (dim 1)."""
        return group.reduce_scatter(x, 1)

    def hier_ag_gemm_multi(self, x, ws, group, cais: CAISConfig):
        """AG→GEMM on the composite group: gather the slow inter-node axis
        first (its index is minor, so the concatenation is this node's
        contiguous block), then the backend's fused schedule on tp_in."""
        xg = self._outer_all_gather(x, group.tp_out, cais)
        return self.ag_gemm_multi(xg, tuple(ws), group.tp_in, cais)

    def hier_gemm_rs(self, x, w, group, cais: CAISConfig):
        """GEMM→RS on the composite group: the backend's fused intra-node
        reduce-scatter first, then the inter-node exchange on 1/tp_in of
        the payload."""
        y = self.gemm_rs(x, w, group.tp_in, cais)
        return self._outer_reduce_scatter(y, group.tp_out, cais)

    def hier_gemm_ar(self, x, w, group, cais: CAISConfig):
        """GEMM→AR: intra-node reduce-scatter → inter-node exchange →
        all-gather back out through both tiers. A ragged sequence that
        cannot scatter over the whole composite ring takes the monolithic
        allreduce over the whole TP group."""
        if int(x.shape[1]) % max(group.size, 1) != 0:
            return prim.barrier_gemm_ar(x, w, group)
        y = self.hier_gemm_rs(x, w, group, cais)
        y = self._outer_all_gather(y, group.tp_out, cais)
        return self._inner_all_gather(y, group.tp_in, cais)

    def hier_a2a_expert_ffn(self, send, ffn, group, cais: CAISConfig):
        """Grouped-EP expert all-to-all: experts replicate across tp_in and
        shard over tp_out only, so the dispatch and combine never cross the
        intra-node ring (``send`` is (tp_out, C, d))."""
        return self.a2a_expert_ffn(send, ffn, group.tp_out, cais)

    def hier_grad_ag_gemm(self, d, wT, group, cais: CAISConfig):
        """Adjoint gather through both tiers: inter-node first, intra-node
        second (the forward hierarchical AG's order)."""
        g = self._outer_all_gather(d, group.tp_out, cais)
        g = self._inner_all_gather(g, group.tp_in, cais)
        return prim.mm(g, wT), g

    def hier_grad_a2a_expert_ffn(self, send, gy, bwd_row, group,
                                 cais: CAISConfig):
        """Grouped-EP adjoint: the grad dispatch and combine run on tp_out
        only, as the forward's; the per-owner expert grads are completed by
        the period backward's sum over tp_in."""
        return self.grad_a2a_expert_ffn(send, gy, bwd_row, group.tp_out,
                                        cais)

    def hier_overlap_asymmetric(self, rs_args, ag_args, group,
                                cais: CAISConfig):
        """The lockstep dual-stream schedule is a one-ring construct; on a
        2D mesh the two sides run as their hierarchical compositions, one
        after the other."""
        x_rs, w_rs = rs_args
        x_ag, w_ag = ag_args
        rs_out = self.gemm_rs(x_rs, w_rs, group, cais)
        multi = isinstance(w_ag, (tuple, list))
        ag_out = self.ag_gemm_multi(x_ag, tuple(w_ag) if multi else (w_ag,),
                                    group, cais)
        return rs_out, (ag_out if multi else ag_out[0])


# ---------------------------------------------------------------------------
# barrier — monolithic collectives around each GEMM
# ---------------------------------------------------------------------------


class BarrierBackend(CollectiveBackend):
    """Communication-centric baseline: opaque collective phases."""

    name = "barrier"

    def ag_gemm_multi(self, x, ws, group, cais):
        if self.hierarchical(group):
            return self.hier_ag_gemm_multi(x, ws, group, cais)
        xg = group.all_gather(x, 1)
        return tuple(prim.mm(xg, w) for w in ws)

    def gemm_rs(self, x, w, group, cais):
        if self.hierarchical(group):
            return self.hier_gemm_rs(x, w, group, cais)
        return prim.barrier_gemm_rs(x, w, group)

    def gemm_ar(self, x, w, group, cais):
        # on a 2D mesh too, ONE opaque allreduce over the whole TP group:
        # the baseline's defining phase structure
        return prim.barrier_gemm_ar(x, w, group)

    def a2a_expert_ffn(self, send, ffn, group, cais):
        if self.hierarchical(group):
            return self.hier_a2a_expert_ffn(send, ffn, group, cais)
        return prim.barrier_a2a_expert_ffn(send, ffn, group)

    def overlap_asymmetric(self, rs_args, ag_args, group, cais):
        if self.hierarchical(group):
            return self.hier_overlap_asymmetric(rs_args, ag_args, group,
                                                cais)
        x_rs, w_rs = rs_args
        x_ag, w_ag = ag_args
        rs_out = prim.barrier_gemm_rs(x_rs, w_rs, group)
        if isinstance(w_ag, (tuple, list)):
            return rs_out, self.ag_gemm_multi(x_ag, tuple(w_ag), group, cais)
        return rs_out, prim.barrier_ag_gemm(x_ag, w_ag, group)


# ---------------------------------------------------------------------------
# cais — decomposed ring schedules with compute-aware chunk planning
# ---------------------------------------------------------------------------


@lru_cache(maxsize=512)
def _planned_chunks(payload_bytes: int, ring: int, bidirectional: bool,
                    hw=None) -> int:
    """coordination.plan() keyed per (payload, ring, hw); ``hw=None`` →
    H100."""
    return coordination.plan(float(payload_bytes), ring,
                             bidirectional=bidirectional,
                             hw=hw or H100).num_chunks


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class CAISBackend(CollectiveBackend):
    """The paper's technique: permute chains interleaved with partial GEMMs,
    chunked per collective by the coordination planner unless the caller
    pins ``CAISConfig.num_chunks``."""

    name = "cais"

    @staticmethod
    def plan_chunks(payload_bytes: float, ring: int,
                    bidirectional: bool = True, hw=None) -> int:
        """The chunking the backend would pick for this collective."""
        return _planned_chunks(int(payload_bytes), ring, bidirectional, hw)

    @staticmethod
    def resolve(cais: CAISConfig, gathered_bytes: float, ring: int,
                inter: bool = False) -> CAISConfig:
        """Fill in num_chunks from the α-β plan when the config leaves it
        open. ``gathered_bytes`` is the full payload the collective moves
        around the ring; ``inter=True`` plans the leg against the
        inter-node tier of ``cais.hw`` (a 2D mesh's slow axis)."""
        if cais.num_chunks is not None or ring <= 1:
            return cais
        hw = cais.hw
        if inter:
            hw = (hw or H100).inter_tier()
        c = _planned_chunks(int(gathered_bytes), ring, cais.bidirectional,
                            hw)
        return dataclasses.replace(cais, num_chunks=c)

    @staticmethod
    def seam_bytes(x, w1) -> int:
        """The gathered z payload of a fused RS→LN→AG seam: (B, S, d) with
        S = x.shape[1] (x is full-sequence) and d = w1's columns."""
        return int(x.shape[0]) * int(x.shape[1]) * int(w1.shape[1]) * \
            x.element_size()

    # the inter-node legs of the hierarchical compositions: ring-decomposed,
    # chunk-planned against the inter-node tier of ``cais.hw``
    def _inner_all_gather(self, x, group, cais):
        return prim.ring_all_gather(x, group, cais)

    def _outer_all_gather(self, x, group, cais):
        ring = group.size
        if ring <= 1:
            return x
        cais = self.resolve(cais, _nbytes(x) * ring, ring, inter=True)
        return prim.ring_all_gather(x, group, cais)

    def _outer_reduce_scatter(self, x, group, cais):
        ring = group.size
        if ring <= 1:
            return x
        if int(x.shape[1]) % ring != 0:
            return group.reduce_scatter(x, 1)
        cais = self.resolve(cais, _nbytes(x), ring, inter=True)
        return prim.ring_reduce_scatter(x, group, cais)

    def ag_gemm_multi(self, x, ws, group, cais):
        if self.hierarchical(group):
            return self.hier_ag_gemm_multi(x, ws, group, cais)
        n = group.size
        cais = self.resolve(cais, _nbytes(x) * n, n)
        return prim.ag_gemm_multi(x, tuple(ws), group, cais)

    def gemm_rs(self, x, w, group, cais):
        if self.hierarchical(group):
            return self.hier_gemm_rs(x, w, group, cais)
        return prim.gemm_rs(x, w, group, cais)

    def gemm_ar(self, x, w, group, cais):
        if self.hierarchical(group):
            return self.hier_gemm_ar(x, w, group, cais)
        # a ragged/decode sequence (S % ring != 0) cannot split around the
        # ring, so this collective falls back to the monolithic allreduce
        if int(x.shape[1]) % group.size != 0:
            return prim.barrier_gemm_ar(x, w, group)
        return prim.gemm_ar(x, w, group, cais)

    def a2a_expert_ffn(self, send, ffn, group, cais):
        if self.hierarchical(group):
            return self.hier_a2a_expert_ffn(send, ffn, group, cais)
        return prim.a2a_expert_ffn(send, ffn, group, cais)

    def fused_rs_ln_ag(self, x, w1, ln_scale, w2, group, cais,
                       norm="rmsnorm", residual=None):
        if self.hierarchical(group):
            # the base composition over this backend's gemm_rs /
            # ag_gemm_multi: each tier plans its own leg inside those
            outs, z = super().fused_rs_ln_ag_multi(
                x, w1, ln_scale, (w2,), group, cais, norm=norm,
                residual=residual)
            return outs[0], z
        cais = self.resolve(cais, self.seam_bytes(x, w1), group.size)
        return prim.fused_rs_ln_ag(x, w1, ln_scale, w2, group, cais,
                                   norm=norm, residual=residual)

    def fused_rs_ln_ag_multi(self, x, w1, ln_scale, ws2, group, cais,
                             norm="rmsnorm", residual=None):
        # the gathered z payload governs both legs; with num_chunks
        # resolved, the base composition over this backend's gemm_rs /
        # ag_gemm_multi is the schedule (on a 2D mesh each tier plans its
        # own leg)
        if not self.hierarchical(group):
            cais = self.resolve(cais, self.seam_bytes(x, w1), group.size)
        return super().fused_rs_ln_ag_multi(x, w1, ln_scale, tuple(ws2),
                                            group, cais, norm=norm,
                                            residual=residual)

    def fused_rs_ln(self, x, w1, ln_scale, group, cais, norm="rmsnorm",
                    residual=None):
        if not self.hierarchical(group):
            cais = self.resolve(cais, self.seam_bytes(x, w1), group.size)
        return super().fused_rs_ln(x, w1, ln_scale, group, cais, norm=norm,
                                   residual=residual)

    def overlap_asymmetric(self, rs_args, ag_args, group, cais):
        if self.hierarchical(group):
            return self.hier_overlap_asymmetric(rs_args, ag_args, group,
                                                cais)
        # no planning: the lockstep schedule moves one S_loc slice per hop
        # on each stream — its chunking is structural
        return prim.overlap_asymmetric(rs_args, ag_args, group, cais)

    def grad_ag_gemm(self, d, wT, group, cais):
        if self.hierarchical(group):
            return self.hier_grad_ag_gemm(d, wT, group, cais)
        # decomposed bidirectional ring gather of the cotangent, then the
        # GEMM against the transposed shard: the grad-side mirror of the
        # forward pull alignment
        n = group.size
        cais = self.resolve(cais, _nbytes(d) * n, n)
        g = prim.ring_all_gather(d, group, cais)
        return prim.mm(g, wT), g

    def grad_a2a_expert_ffn(self, send, gy, bwd_row, group, cais):
        if self.hierarchical(group):
            return self.hier_grad_a2a_expert_ffn(send, gy, bwd_row, group,
                                                 cais)
        # interleaved per-offset ± schedule mirroring the forward a2a; the
        # chunking is structural (one (row, cotangent) pair per offset), so
        # nothing is planned here
        return prim.grad_a2a_expert_ffn(send, gy, bwd_row, group, cais)


# ---------------------------------------------------------------------------
# auto — framework-scheduled reference (DTensor in torch)
# ---------------------------------------------------------------------------


class AutoBackend(BarrierBackend):
    """``explicit = False``: the model path runs no explicit schedule for
    it, but the one-device code on DTensors placed as the TP shards are
    (``models.transformer``'s ``auto`` route). Its inherited monolithic
    methods still execute graphs."""

    name = "auto"
    explicit = False


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, CollectiveBackend] = {}


def register_backend(backend: CollectiveBackend,
                     name: Optional[str] = None) -> CollectiveBackend:
    """Register (or replace) a backend under ``name or backend.name``."""
    key = name or backend.name
    if not key or key == "abstract":
        raise ValueError("backend must carry a concrete name")
    _REGISTRY[key] = backend
    return backend


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: Union[str, CollectiveBackend]) -> CollectiveBackend:
    """Resolve a backend by name (instances pass through unchanged)."""
    if isinstance(name, CollectiveBackend):
        return name
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown collective backend {name!r}; available: "
            f"{available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


register_backend(BarrierBackend())
register_backend(CAISBackend())
register_backend(AutoBackend())
