"""Decoder-only LM assembled from an ArchConfig: the paged serving path of
``repro/models/transformer.py``.

JAX scans the stack over pattern periods with parameters stacked per
period; here the blocks are an ``nn.ModuleList`` in layer order and the
stack is a Python loop (``repro_torch.bridge`` maps the stacked JAX layout
onto it). On one device there is no TP context, so ``stack_step`` runs the
per-block branch of JAX's ``_blocks_step`` for every layer. ``Block`` and
``MLP`` construction take the place of ``init_block`` / ``init_mlp``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import Norm, embed_init_, softcap
from repro_torch.runtime import Runtime, resolve_device

# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _has_ffn(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


class Block(nn.Module):
    """Pre-norm residual block: norm1 → mixer → (+x) → norm2 → ffn → (+x);
    ``kind`` is "attn" or "swa" (sliding window ``cfg.window``)."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        if kind not in ("attn", "swa"):
            raise NotImplementedError(f"{kind!r} blocks are not ported yet")
        self.kind = kind
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.mixer = attn.Attention(cfg, dtype, device)
        self.norm2 = self.ffn = None
        if _has_ffn(cfg):
            self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.ffn = ffn_mod.init_ffn(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        if self.ffn is not None:
            self.ffn.reset_parameters(generator)


def block_step(params: Block, x: torch.Tensor, pool: attn.Pool,
               view: attn.KVView, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, attn.Pool]:
    """One block of a mixed prefill/decode serving step against its paged
    KV pool (updated in place). Returns (x, pool)."""
    window = cfg.window if params.kind == "swa" else 0
    h = params.norm1(x)
    mixed, pool = attn.attention_paged(params.mixer, h, pool, view, cfg,
                                       window=window)
    x = x + mixed
    if _has_ffn(cfg):
        x = x + ffn_mod.ffn_forward(params.ffn, params.norm2(x), cfg)
    return x, pool


def stack_step(blocks: nn.ModuleList, x: torch.Tensor,
               pools: List[attn.Pool], view: attn.KVView, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, List[attn.Pool]]:
    """One mixed prefill/decode serving step through the whole stack, layer
    by layer; ``pools[i]`` belongs to layer ``i`` (updated in place)."""
    for blk, pool in zip(blocks, pools):
        x, _ = block_step(blk, x, pool, view, cfg)
    return x, pools


def init_stack_pools(cfg: ArchConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype, device: torch.device
                     ) -> List[attn.Pool]:
    """Paged KV pools for the whole stack, one per layer in layer order."""
    return [attn.init_kv_pool(cfg, num_blocks, block_size, dtype, device)
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# LM — the top-level decoder-only model
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """Decoder-only language model (dense attention archs).

    Parameters live on ``device`` (CUDA unless the caller names another) in
    ``rt.param_dtype``; activations run in ``rt.compute_dtype``. With
    ``seed`` set, the weights are drawn from a ``torch.Generator`` on that
    device; with ``seed=None`` they are left uninitialised, for a caller
    that loads a state dict (``repro_torch.bridge``)."""

    def __init__(self, cfg: ArchConfig, rt: Runtime = Runtime(), *,
                 device=None, seed: Optional[int] = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.rt = cfg, rt
        dtype = rt.pdtype
        param = lambda *s: nn.Parameter(
            torch.empty(s, dtype=dtype, device=device), requires_grad=False)
        self.embed = param(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(
            Block(kind, cfg, dtype, device) for kind in cfg.layer_kinds())
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.lm_head = None if cfg.tie_embeddings \
            else param(cfg.d_model, cfg.vocab_size)
        if seed is not None:
            self.reset_parameters(
                torch.Generator(device=device).manual_seed(seed))

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

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        head = self.embed.T if self.lm_head is None else self.lm_head
        return softcap((x @ head.to(x.dtype)).float(), self.cfg.logits_softcap)

    # ----- paged serving (docs/serving.md) -----
    def init_pools(self, num_blocks: int, block_size: int) -> List[attn.Pool]:
        return init_stack_pools(self.cfg, num_blocks, block_size,
                                self.rt.dtype, self.device)

    @torch.no_grad()
    def serve_step(self, tokens: torch.Tensor, pools: List[attn.Pool],
                   view: attn.KVView) -> Tuple[torch.Tensor, List[attn.Pool]]:
        """One mixed prefill/decode step against paged KV pools.
        tokens: (B, S_step) int (0 at padding positions). Returns the
        per-row logits at each row's last valid position, (B, 1, V) f32,
        and the pools (updated in place)."""
        x = self._embed(tokens, self.rt.dtype)
        x, pools = stack_step(self.blocks, x, pools, view, self.cfg)
        B = x.shape[0]
        x_last = x[torch.arange(B, device=x.device), view.last.long()][:, None]
        return self.logits(self.final_norm(x_last)), pools
