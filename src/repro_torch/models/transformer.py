"""Decoder-only LM assembled from an ArchConfig: the training forward and
loss, prefill/decode over dense caches, and the paged serving path, of
``repro/models/transformer.py``.

JAX scans the stack over pattern periods with parameters stacked per
period; here the blocks are an ``nn.ModuleList`` in layer order and the
stack is a Python loop over periods (``repro_torch.bridge`` maps the stacked
JAX layout onto it). ``Block`` and ``MLP`` construction take the place of
``init_block`` / ``init_mlp``.

On a TP ring (``LM(..., group=...)`` with more than one rank and an
explicit backend in ``rt.tp.mode``) each rank holds its shards of the TP
weights, the embedded activation is cut to this rank's sequence shard, every
period runs as one dataflow graph (:func:`repro_torch.core.tp.sp_period`)
and stays sequence-sharded between periods, and the loss's (sum, count) is
all-reduced over the ring. Paged serving (``serve_step``) on a ring keeps
the activation whole on every rank and runs each period as one serve graph
(:func:`repro_torch.core.tp.sp_serve_period`) against the rank's KV pools;
the embedding and head are whole on every rank, so every rank computes the
same logits. On one device there is no TP context and every block takes the
per-block path, as in JAX.

Training: ``forward`` and ``loss`` are differentiable once the parameters
require grad (``repro_torch.train.step.init_state`` sets that; the model is
built frozen, for serving). On a ring each period's backward is graph-built
(``sp_period``); the ring's partial grads of the replicated embedding, head
and final norm are summed by :meth:`LM.sync_grads`, once, after backward.
``Runtime.remat`` checkpoints each period and the remainder tail on one
device (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``); a period on a
ring already saves only (x, weights) for its graph-built backward, which
re-executes the forward, so there it adds nothing and is not applied (JAX's
``jax.checkpoint`` around its ``custom_vjp`` runs that forward a third
time: the same values). Serving over dense caches (``prefill`` /
``decode_step``) runs on one device only (ROADMAP A11, A12); MLA blocks run
on one device only (JAX's mixer never shards MLA) and have no paged path
(their cache is a latent, not K/V).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import tp as tp_mod
from repro_torch.core.backends import get_backend
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import Norm, embed_init_, softcap
from repro_torch.runtime import Runtime, resolve_device
from repro_torch.sharding import TPGroup

# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _has_ffn(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


class Block(nn.Module):
    """Pre-norm residual block: norm1 → mixer → (+x) → norm2 → ffn → (+x);
    ``kind`` is "attn", "swa" (sliding window ``cfg.window``) or "mla"
    (whole on every rank: MLA is never sharded)."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, tp: int = 1):
        super().__init__()
        if kind not in ("attn", "swa", "mla"):
            raise NotImplementedError(f"{kind!r} blocks are not ported yet")
        self.kind = kind
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mixer = attn.MLA(cfg, dtype, device) if kind == "mla" \
            else attn.Attention(cfg, dtype, device, tp)
        self.norm2 = self.ffn = None
        if _has_ffn(cfg):
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.ffn = ffn_mod.init_ffn(cfg, dtype, device, tp)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        if self.ffn is not None:
            self.ffn.reset_parameters(generator)


def _tp_context(rt: Runtime, group: Optional[TPGroup]
                ) -> Optional[tp_mod.TPContext]:
    """The TP execution context for ``group``, through the one
    ``TPConfig → TPContext.from_config`` path; None on one device. The
    ``auto`` backend (the compiler-scheduled reference in JAX; DTensor in
    torch, ROADMAP A5) raises on a larger group instead of quietly computing
    unsharded."""
    if group is None or group.size <= 1:
        return None
    if not get_backend(rt.tp.mode).explicit:
        raise NotImplementedError(
            f"tp mode {rt.tp.mode!r} leaves scheduling to the framework; its "
            "torch counterpart (DTensor) is not ported yet (ROADMAP A5): use "
            "'barrier' or 'cais' on a TP group")
    if not rt.tp.sequence_parallel:
        raise NotImplementedError("TP without sequence parallelism is not "
                                  "ported yet (ROADMAP A11)")
    return tp_mod.TPContext.from_config(rt.tp, group)


def _whole_block_applicable(cfg: ArchConfig, kind: str, tp: int,
                            route_ring: Optional[int] = None) -> bool:
    """Can this block run as ONE dataflow graph (attention AND FFN side
    both explicit-TP-applicable)?"""
    return (kind in ("attn", "swa") and tp_mod.tp_applicable(cfg, kind, tp)
            and _has_ffn(cfg)
            and (tp_mod.tp_applicable(cfg, "moe", tp, route_ring)
                 or tp_mod.tp_applicable(cfg, "ffn", tp)))


def block_forward(kind: str, params: Block, x: torch.Tensor,
                  cfg: ArchConfig, tpc: Optional[tp_mod.TPContext] = None,
                  prefix_len: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block. Returns (x, aux_loss). On a TP ring the
    whole block runs as one dataflow graph (``sp_block``) on this rank's
    sequence shard; the per-sub-layer TP graphs JAX falls back to for a
    block that is only partly TP-applicable are not ported."""
    if tpc is not None:
        if not _whole_block_applicable(cfg, kind, tpc.tp, tpc.route_ring):
            raise NotImplementedError(
                f"{cfg.name}: a {kind!r} block that is not whole-block "
                f"TP-applicable at tp={tpc.tp} is not ported yet")
        return tp_mod.sp_block(tpc, x, params, cfg, kind,
                               prefix_len=prefix_len, norm_kind=cfg.norm)
    x = x + _mixer_forward(kind, params.mixer, params.norm1(x), cfg,
                           prefix_len)
    x = _ffn_residual(params, x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _mixer_forward(kind: str, mixer, h: torch.Tensor, cfg: ArchConfig,
                   prefix_len: int = 0) -> torch.Tensor:
    if kind == "mla":
        return attn.mla_forward(mixer, h, cfg)
    return attn.attention_forward(mixer, h, cfg, window=_window(kind, cfg),
                                  prefix_len=prefix_len)


def _window(kind: str, cfg: ArchConfig) -> int:
    return cfg.window if kind == "swa" else 0


def _ffn_residual(params: Block, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    if _has_ffn(cfg):
        x = x + ffn_mod.ffn_forward(params.ffn, params.norm2(x), cfg)
    return x


def _blocks_forward(kinds: Sequence[str], blocks: Sequence[Block],
                    x: torch.Tensor, cfg: ArchConfig,
                    tpc: Optional[tp_mod.TPContext] = None,
                    prefix_len: int = 0):
    """Run consecutive blocks: on a TP ring, when every block is
    whole-block TP-applicable, as ONE period-level dataflow graph
    (``sp_period``); otherwise block by block."""
    if (tpc is not None and len(blocks) > 0
            and all(_whole_block_applicable(cfg, k, tpc.tp, tpc.route_ring)
                    for k in kinds)):
        return tp_mod.sp_period(tpc, x, list(blocks), cfg, kinds,
                                prefix_len=prefix_len, norm_kind=cfg.norm)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, blk in zip(kinds, blocks):
        x, a = block_forward(kind, blk, x, cfg, tpc, prefix_len)
        aux = aux + a
    return x, aux


def stack_forward(blocks: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig,
                  tpc: Optional[tp_mod.TPContext] = None,
                  prefix_len: int = 0, remat: bool = False):
    """The whole stack, one ``layer_pattern`` period at a time (JAX's
    ``lax.scan`` over stacked periods), then the remainder layers. With
    ``remat`` (where autograd records) each period and the remainder tail
    keep only their input for the backward and run their forward again
    there (``torch.utils.checkpoint``, non-reentrant)."""
    pattern = tuple(cfg.layer_pattern)
    P = len(pattern)
    n_full = cfg.num_layers // P
    remat = remat and torch.is_grad_enabled()

    def run(kinds, blks, x):
        if remat:
            return checkpoint(_blocks_forward, kinds, blks, x, cfg, tpc,
                              prefix_len, use_reentrant=False)
        return _blocks_forward(kinds, blks, x, cfg, tpc, prefix_len)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in range(n_full):
        x, a = run(pattern, blocks[p * P:(p + 1) * P], x)
        aux = aux + a
    rem = cfg.layer_kinds()[n_full * P:]
    if rem:
        x, a = run(rem, blocks[n_full * P:], x)
        aux = aux + a
    return x, aux


# ----- prefill / decode over dense caches -----------------------------------


def block_prefill(params: Block, x: torch.Tensor, cfg: ArchConfig,
                  s_max: Optional[int] = None
                  ) -> Tuple[torch.Tensor, attn.Cache]:
    """Pre-norm residual block over the prompt; returns (x, the layer's
    decode cache)."""
    h = params.norm1(x)
    if params.kind == "mla":
        mixed, cache = attn.mla_prefill(params.mixer, h, cfg, s_max=s_max)
    else:
        mixed, cache = attn.attention_prefill(
            params.mixer, h, cfg, window=_window(params.kind, cfg),
            s_max=s_max)
    return _ffn_residual(params, x + mixed, cfg), cache


def block_decode(params: Block, x: torch.Tensor, cache: attn.Cache,
                 idx: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, attn.Cache]:
    """One decode step of one block; ``cache`` is updated in place."""
    h = params.norm1(x)
    if params.kind == "mla":
        mixed, cache = attn.mla_decode(params.mixer, h, cache, idx, cfg)
    else:
        mixed, cache = attn.attention_decode(
            params.mixer, h, cache, idx, cfg,
            window=_window(params.kind, cfg))
    return _ffn_residual(params, x + mixed, cfg), cache


def init_block_cache(kind: str, cfg: ArchConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device) -> attn.Cache:
    if kind == "attn":
        return attn.init_dense_cache(cfg, batch, s_max, dtype, device)
    if kind == "swa":
        return attn.init_swa_cache(cfg, batch, cfg.window, dtype, device)
    if kind == "mla":
        return attn.init_mla_cache(cfg, batch, s_max, dtype, device)
    raise NotImplementedError(f"{kind!r} caches are not ported yet")


def stack_prefill(blocks: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig,
                  s_max: Optional[int] = None
                  ) -> Tuple[torch.Tensor, List[attn.Cache]]:
    """The whole stack over the prompt, layer by layer; returns (x, one
    cache per layer in layer order)."""
    caches = []
    for blk in blocks:
        x, c = block_prefill(blk, x, cfg, s_max)
        caches.append(c)
    return x, caches


def stack_decode(blocks: nn.ModuleList, x: torch.Tensor,
                 caches: List[attn.Cache], idx: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, List[attn.Cache]]:
    """One decode step through the whole stack; ``caches[i]`` belongs to
    layer ``i`` (updated in place)."""
    for blk, c in zip(blocks, caches):
        x, _ = block_decode(blk, x, c, idx, cfg)
    return x, caches


def init_stack_cache(cfg: ArchConfig, batch: int, s_max: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> List[attn.Cache]:
    """Empty decode caches for the whole stack, one per layer in layer
    order."""
    return [init_block_cache(kind, cfg, batch, s_max, dtype, device)
            for kind in cfg.layer_kinds()]


# ----- paged serving ---------------------------------------------------------


def block_step(params: Block, x: torch.Tensor, pool: attn.Pool,
               view: attn.KVView, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, attn.Pool]:
    """One block of a mixed prefill/decode serving step against its paged
    KV pool (updated in place), on one device. Returns (x, pool). Attention
    blocks only: an MLA layer caches a latent, which the pools do not hold
    (JAX's ``paged_supported`` gate)."""
    if params.kind not in ("attn", "swa"):
        raise NotImplementedError(f"{params.kind!r} blocks have no paged "
                                  "path; serve them through the dense engine")
    h = params.norm1(x)
    mixed, pool = attn.attention_paged(params.mixer, h, pool, view, cfg,
                                       window=_window(params.kind, cfg))
    return _ffn_residual(params, x + mixed, cfg), pool


def _blocks_step(kinds: Sequence[str], blocks: Sequence[Block],
                 x: torch.Tensor, pools: Sequence[attn.Pool],
                 view: attn.KVView, cfg: ArchConfig,
                 tpc: Optional[tp_mod.TPContext] = None):
    """Consecutive blocks of a serving step. On a TP ring, when every block
    is whole-block TP-applicable (attention kinds, dense FFN), the period
    runs as ONE serve graph (``sp_serve_period``: replicated activation,
    ``gemm_ar`` reductions, the pools through each core node); otherwise
    the rank raises (JAX falls back per block under GSPMD; the port has no
    such fallback, ROADMAP A5). On one device, block by block."""
    if tpc is None:
        for blk, pool in zip(blocks, pools):
            x, _ = block_step(blk, x, pool, view, cfg)
        return x, list(pools)
    if cfg.moe is not None or not all(
            _whole_block_applicable(cfg, k, tpc.tp, tpc.route_ring)
            for k in kinds):
        raise NotImplementedError(
            f"{cfg.name}: serving blocks {tuple(kinds)} that are not "
            f"whole-block TP-applicable at tp={tpc.tp} is not ported yet "
            "(ROADMAP A5)")
    return tp_mod.sp_serve_period(tpc, x, list(blocks), cfg, kinds,
                                  list(pools), view, norm_kind=cfg.norm)


def stack_step(blocks: nn.ModuleList, x: torch.Tensor,
               pools: List[attn.Pool], view: attn.KVView, cfg: ArchConfig,
               tpc: Optional[tp_mod.TPContext] = None
               ) -> Tuple[torch.Tensor, List[attn.Pool]]:
    """One mixed prefill/decode serving step through the whole stack, one
    ``layer_pattern`` period at a time, then the remainder layers (as
    :func:`stack_forward`); ``pools[i]`` belongs to layer ``i`` (updated in
    place)."""
    P = len(cfg.layer_pattern)
    n_full = cfg.num_layers // P
    kinds = cfg.layer_kinds()
    spans = [(p * P, (p + 1) * P) for p in range(n_full)]
    if n_full * P < cfg.num_layers:
        spans.append((n_full * P, cfg.num_layers))
    for lo, hi in spans:
        x, _ = _blocks_step(kinds[lo:hi], blocks[lo:hi], x, pools[lo:hi],
                            view, cfg, tpc)
    return x, pools


def init_stack_pools(cfg: ArchConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype, device: torch.device, tp: int = 1
                     ) -> List[attn.Pool]:
    """Paged KV pools for the whole stack, one per layer in layer order,
    with a rank's kv heads on a ring of ``tp``
    (:func:`repro_torch.models.attention.init_kv_pool`)."""
    return [attn.init_kv_pool(cfg, num_blocks, block_size, dtype, device, tp)
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# LM head / loss
# ---------------------------------------------------------------------------


def chunked_ce_loss(x: torch.Tensor, embed_or_head: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    cfg: ArchConfig, rt: Runtime, tied: bool,
                    group: Optional[TPGroup] = None) -> torch.Tensor:
    """Mean cross-entropy with logits computed per sequence chunk (bounds
    the (B, chunk, V) logits). x: (B, S, d) — on a TP ring this rank's
    sequence shard, with the matching slices of ``labels`` and ``mask``;
    the (sum, count) pair is then all-reduced over ``group``."""
    B, S, _ = x.shape
    chunk = min(rt.loss_chunk, S)
    while S % chunk:
        chunk //= 2
    w = embed_or_head.T if tied else embed_or_head    # (d, V)
    w = w.to(x.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        logits = softcap((x[:, s0:s0 + chunk] @ w).float(),
                         cfg.logits_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        yc = labels[:, s0:s0 + chunk].long()
        gold = torch.gather(logits, -1, yc[..., None])[..., 0]
        mc = mask[:, s0:s0 + chunk].float()
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    if group is not None and group.size > 1:
        tot, cnt = _RingSum.apply(torch.stack([tot, cnt]), group)
    return tot / torch.clamp(cnt, min=1.0)


class _RingSum(torch.autograd.Function):
    """The loss's all-reduce of (sum, count) over the ring, differentiable
    with an identity backward: every rank seeds the same cotangent of the
    same replicated loss, which is already each rank's cotangent of its own
    partial sum (an all-reduce there would make every grad tp times too
    large)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


# ---------------------------------------------------------------------------
# LM — the top-level decoder-only model
# ---------------------------------------------------------------------------


AUX_LOSS_WEIGHT = 0.01


class LM(nn.Module):
    """Decoder-only language model (dense attention and MLA archs).

    Parameters live on ``device`` (CUDA unless the caller names another) in
    ``rt.param_dtype``; activations run in ``rt.compute_dtype``. With
    ``seed`` set, the weights are drawn from a ``torch.Generator`` on that
    device; with ``seed=None`` they are left uninitialised, for a caller
    that loads a state dict (``repro_torch.bridge``). With a ``group`` of
    more than one rank the model holds this rank's shards of the TP weights
    (the same weights as the one-device model from the same seed)."""

    def __init__(self, cfg: ArchConfig, rt: Runtime = Runtime(), *,
                 device=None, seed: Optional[int] = 0,
                 group: Optional[TPGroup] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.rt, self.group = cfg, rt, group
        tp = self.tp
        dtype = rt.pdtype
        param = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        self.embed = param(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(
            Block(kind, cfg, dtype, device, tp) for kind in cfg.layer_kinds())
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.lm_head = None if cfg.tie_embeddings \
            else param(cfg.d_model, cfg.vocab_size)
        if seed is None:
            return
        if tp == 1:
            self.reset_parameters(
                torch.Generator(device=device).manual_seed(seed))
            return
        # the same weights as the one-device model from this seed: draw them
        # whole, keep this rank's shards
        from repro_torch.bridge import shard_state_dict

        full = LM(cfg, rt, device=device, seed=seed)
        self.load_state_dict(shard_state_dict(full.state_dict(), cfg,
                                              group.rank, tp))

    @property
    def tp(self) -> int:
        """The TP ring size this model's weights are sharded over."""
        return 1 if self.group is None else self.group.size

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        embed_init_(self.embed, generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        if self.lm_head is not None:
            embed_init_(self.lm_head, generator)

    def _embed(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.embed[tokens.long()].to(dtype)

    def _head(self) -> Tuple[torch.Tensor, bool]:
        tied = self.cfg.tie_embeddings
        return (self.embed if tied else self.lm_head), tied

    # ----- training forward -----
    def forward(self, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hidden states after the final norm, and the aux loss. tokens:
        (B, S) int, the whole sequence on every rank; on a TP ring the
        result is this rank's sequence shard (B, S/tp, d)."""
        tpc = _tp_context(self.rt, self.group)
        x = self._embed(tokens, self.rt.dtype)
        if tpc is not None:
            x = x[:, self._seq_shard(x.shape[1])].contiguous()
        x, aux = stack_forward(self.blocks, x, self.cfg, tpc,
                               remat=self.rt.remat and tpc is None)
        return self.final_norm(x), aux

    def sharded_names(self) -> frozenset:
        """The parameters this rank holds a shard of (the rest every rank of
        the ring holds whole)."""
        from repro_torch.core.tp import param_shard_dim

        return frozenset(n for n, _ in self.named_parameters()
                         if param_shard_dim(n, self.cfg, self.tp) is not None)

    def sync_grads(self) -> None:
        """Sum over the ring, once, the grads of the parameters outside the
        period graphs (embedding, head, final norm): each rank's are the
        partial sums of its sequence shard. The period graphs' replicated
        weights are summed in their own backward. A no-op on one device."""
        if self.tp == 1:
            return
        for name, p in self.named_parameters():
            if not name.startswith("blocks.") and p.grad is not None:
                p.grad = self.group.all_reduce(p.grad)

    def _seq_shard(self, S: int) -> slice:
        if S % self.tp:
            raise NotImplementedError(
                f"sequence length {S} does not split over {self.tp} ranks: "
                "the ragged layout is not ported yet (ROADMAP A11)")
        s = S // self.tp
        return slice(self.group.rank * s, (self.group.rank + 1) * s)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy (+ the weighted aux loss) of
        ``batch`` ({"tokens", "labels"[, "mask"]}, each (B, S)). The same
        value on every rank of a TP ring."""
        tokens, labels = batch["tokens"], batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        x, aux = self.forward(tokens)
        if self.tp > 1:
            sl = self._seq_shard(labels.shape[1])
            labels, mask = labels[:, sl], mask[:, sl]
        head, tied = self._head()
        ce = chunked_ce_loss(x, head, labels, mask, self.cfg, self.rt, tied,
                             self.group)
        return ce + AUX_LOSS_WEIGHT * aux

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        return softcap((x @ head.to(x.dtype)).float(), self.cfg.logits_softcap)

    # ----- serving over dense caches -----
    def _one_device(self, what: str) -> None:
        if self.tp > 1:
            raise NotImplementedError(f"{what} over a TP ring is not ported "
                                      "yet (ROADMAP A11, A12)")

    def init_cache(self, batch: int, s_max: int) -> List[attn.Cache]:
        return init_stack_cache(self.cfg, batch, s_max, self.rt.dtype,
                                self.device)

    @torch.no_grad()
    def prefill(self, tokens, s_max: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[attn.Cache]]:
        """The prompt through the stack. ``tokens``: (B, S) int, or a batch
        dict with a "tokens" entry. Returns the last position's logits,
        (B, 1, V) f32, and the per-layer caches of ``s_max`` slots (default
        S)."""
        self._one_device("prefill")
        if isinstance(tokens, dict):
            tokens = tokens["tokens"]
        x = self._embed(tokens, self.rt.dtype)
        x, caches = stack_prefill(self.blocks, x, self.cfg,
                                  s_max or tokens.shape[1])
        return self.logits(self.final_norm(x[:, -1:])), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List[attn.Cache],
                    idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, List[attn.Cache]]:
        """token: (B, 1) int; idx: (B,) int32 positions of the new tokens.
        Returns the logits (B, 1, V) f32 and the caches (updated in
        place)."""
        self._one_device("decode")
        x = self._embed(token, self.rt.dtype)
        x, caches = stack_decode(self.blocks, x, caches, idx, self.cfg)
        return self.logits(self.final_norm(x)), caches

    # ----- paged serving (docs/serving.md) -----
    def init_pools(self, num_blocks: int, block_size: int) -> List[attn.Pool]:
        """This rank's paged KV pools (its kv heads on a ring)."""
        return init_stack_pools(self.cfg, num_blocks, block_size,
                                self.rt.dtype, self.device, self.tp)

    @torch.no_grad()
    def serve_step(self, tokens: torch.Tensor, pools: List[attn.Pool],
                   view: attn.KVView) -> Tuple[torch.Tensor, List[attn.Pool]]:
        """One mixed prefill/decode step against paged KV pools.
        tokens: (B, S_step) int (0 at padding positions). Returns the
        per-row logits at each row's last valid position, (B, 1, V) f32,
        and the pools (updated in place). On a TP ring every rank passes the
        same tokens and view with its own pools (:meth:`init_pools`) and
        gets the same logits."""
        if any(b.kind not in ("attn", "swa") for b in self.blocks):
            raise NotImplementedError(
                f"{self.cfg.name}: only attention blocks have a paged path; "
                "serve the others through the dense engine")
        tpc = _tp_context(self.rt, self.group)
        x = self._embed(tokens, self.rt.dtype)
        x, pools = stack_step(self.blocks, x, pools, view, self.cfg, tpc)
        B = x.shape[0]
        x_last = x[torch.arange(B, device=x.device), view.last.long()][:, None]
        return self.logits(self.final_norm(x_last)), pools
