"""Encoder-decoder LM (whisper-tiny), the counterpart of
``repro/models/encdec.py``.

The audio conv frontend is a stub, as in JAX: the inputs carry precomputed
frame embeddings ``(B, T_enc, d_model)``. The encoder's blocks are
non-causal self-attention without rope, then the (non-gated) MLP; each
decoder block is causal self-attention with rope (cached at decode), then
cross-attention over the encoder output's K/V, computed once at prefill
(:func:`repro_torch.models.attention.cross_attention_kv`, no rope), then
the MLP. The embedding is a plain lookup, no scale; the head is tied.

Blocks are ``nn.ModuleList``s in layer order (JAX stacks them on a leading
axis; :mod:`repro_torch.bridge` unstacks). The decoder block's
self-attention is ``self_attn`` (JAX's ``"self"``). Every attention core
goes through :mod:`repro_torch.kernels.ops` (the flash kernel on the card,
its ``causal=False`` branch for the encoder and the cross-attention).

One device only: JAX has no explicit-TP path for the enc-dec family (its
``EncDecLM.loss`` never calls the period graphs), so a TP group or a mesh
raises (ROADMAP A15).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import Norm, embed_init_
from repro_torch.optim.optimizers import Leaf
from repro_torch.models.transformer import chunked_ce_loss
from repro_torch.runtime import Runtime, resolve_device

Caches = Dict[str, List[attn.Cache]]   # {"self": [...], "cross": [...]}


class EncBlock(nn.Module):
    """norm1, attn (non-causal, no rope), norm2, ffn."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.attn = attn.Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.ffn = ffn_mod.init_ffn(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.ffn.reset_parameters(generator)


class DecBlock(nn.Module):
    """norm1, self_attn (causal, rope), norm_x, cross, norm2, ffn."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.norm1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.self_attn = attn.Attention(cfg, dtype, device)
        self.norm_x = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.cross = attn.init_cross_attention(cfg, dtype, device)
        self.norm2 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.ffn = ffn_mod.init_ffn(cfg, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.self_attn, self.cross, self.ffn):
            m.reset_parameters(generator)


def enc_block_forward(params: EncBlock, x: torch.Tensor,
                      cfg: ArchConfig) -> torch.Tensor:
    """One encoder block over x (B, T, d): every frame sees every frame."""
    B, T, _ = x.shape
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    dtype = x.dtype
    pos = attn._arange_positions(B, T, x.device)
    h = params.norm1(x)
    q = (h @ params.attn.wq.to(dtype)).reshape(B, T, H, dh)
    k = (h @ params.attn.wk.to(dtype)).reshape(B, T, Hkv, dh)
    v = (h @ params.attn.wv.to(dtype)).reshape(B, T, Hkv, dh)
    o = attn.attention_core(q, k, v, q_positions=pos, kv_positions=pos,
                            causal=False)
    x = x + o.reshape(B, T, -1) @ params.attn.wo.to(dtype)
    return x + ffn_mod.mlp_forward(params.ffn, params.norm2(x), cfg.act)


def _dec_tail(params: DecBlock, x: torch.Tensor, cross_kv: attn.Cache,
              cfg: ArchConfig) -> torch.Tensor:
    """x + cross(norm_x(x)), then + ffn(norm2(·))."""
    x = x + attn.cross_attention(params.cross, params.norm_x(x), cross_kv,
                                 cfg)
    return x + ffn_mod.mlp_forward(params.ffn, params.norm2(x), cfg.act)


def dec_block_forward(params: DecBlock, x: torch.Tensor, cross_kv: attn.Cache,
                      cfg: ArchConfig) -> torch.Tensor:
    x = x + attn.attention_forward(params.self_attn, params.norm1(x), cfg)
    return _dec_tail(params, x, cross_kv, cfg)


def dec_block_prefill(params: DecBlock, x: torch.Tensor,
                      cross_kv: attn.Cache, cfg: ArchConfig,
                      s_max: Optional[int] = None
                      ) -> Tuple[torch.Tensor, attn.Cache]:
    mixed, cache = attn.attention_prefill(params.self_attn, params.norm1(x),
                                          cfg, s_max=s_max)
    return _dec_tail(params, x + mixed, cross_kv, cfg), cache


def dec_block_decode(params: DecBlock, x: torch.Tensor, cache: attn.Cache,
                     cross_kv: attn.Cache, idx: torch.Tensor,
                     cfg: ArchConfig) -> Tuple[torch.Tensor, attn.Cache]:
    mixed, cache = attn.attention_decode(params.self_attn, params.norm1(x),
                                         cache, idx, cfg)
    return _dec_tail(params, x + mixed, cross_kv, cfg), cache


class EncDecLM(nn.Module):
    """The whisper-style encoder-decoder on one device (CUDA unless the
    caller names another): ``embed`` (V, d), ``enc_blocks``, ``enc_norm``,
    ``dec_blocks``, ``dec_norm``, in ``rt.param_dtype``; activations in
    ``rt.compute_dtype``. ``seed`` draws the weights from a
    ``torch.Generator`` on the device; ``seed=None`` leaves them for a
    state dict. The train step's TP hooks (``tp``, ``dp``, ``data``,
    ``split_groups``, ``sync_grads``) are those of one device."""

    tp = dp = 1
    group = data = mesh = None

    def __init__(self, cfg: ArchConfig, rt: Runtime = Runtime(), *,
                 device=None, seed: Optional[int] = 0, group=None):
        super().__init__()
        if cfg.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder: build an LM")
        if group is not None:
            raise NotImplementedError(
                f"{cfg.name}: the enc-dec model takes no TP group or mesh "
                "(ROADMAP A15: enc-dec on a ring; JAX has no explicit-TP "
                "path for it; under tp mode 'auto', ROADMAP A5 (b))")
        device = resolve_device(device)
        self.cfg, self.rt = cfg, rt
        dtype = rt.pdtype
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, dtype=dtype, device=device),
            requires_grad=False)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, dtype, device)
            for _ in range(cfg.encoder.num_layers))
        self.enc_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, dtype, device) for _ in range(cfg.num_layers))
        self.dec_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        if seed is not None:
            self.reset_parameters(
                torch.Generator(device=device).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        embed_init_(self.embed, generator)
        for blk in (*self.enc_blocks, *self.dec_blocks):
            blk.reset_parameters(generator)

    def split_groups(self) -> dict:
        return {}

    def opt_leaves(self) -> dict:
        """{parameter: its ``repro`` leaf and stack index}
        (:meth:`repro_torch.models.transformer.LM.opt_leaves`)."""
        from repro_torch.bridge import jax_leaf

        return {n: Leaf(*jax_leaf(n, self.cfg))
                for n, _ in self.named_parameters()}

    def sync_grads(self, seq: int, data: bool = True) -> None:
        """Nothing to sum on one device."""

    def _run(self, fn, *args):
        """``fn(*args)``, checkpointed where ``rt.remat`` asks and autograd
        records (JAX's ``jax.checkpoint`` around each scanned block)."""
        if self.rt.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # ----- encoder -----
    def encode(self, src_embed: torch.Tensor) -> torch.Tensor:
        """The encoder over frame embeddings (B, T, d) -> (B, T, d)."""
        x = src_embed.to(self.rt.dtype)
        for blk in self.enc_blocks:
            x = self._run(enc_block_forward, blk, x, self.cfg)
        return self.enc_norm(x)

    def _cross_kvs(self, enc_out: torch.Tensor) -> List[attn.Cache]:
        """Each decoder layer's cross K/V of ``enc_out``."""
        return [attn.cross_attention_kv(blk.cross, enc_out, self.cfg)
                for blk in self.dec_blocks]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed[tokens.long()].to(self.rt.dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.embed.T.to(x.dtype)).float()

    # ----- training -----
    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy of the decoder over ``batch``
        ({"src_embed" (B, T, d), "tokens", "labels"[, "mask"]})."""
        labels = batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32,
                              device=labels.device)
        kvs = self._cross_kvs(self.encode(batch["src_embed"]))
        x = self._embed(batch["tokens"])
        for blk, kv in zip(self.dec_blocks, kvs):
            x = self._run(dec_block_forward, blk, x, kv, self.cfg)
        x = self.dec_norm(x)
        return chunked_ce_loss(x, self.embed, labels, mask, self.cfg,
                               self.rt, tied=True)

    # ----- serving -----
    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                s_max: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """The encoder over ``batch["src_embed"]`` and the decoder over the
        prompt ``batch["tokens"]`` (B, S). Returns the last position's
        logits (B, 1, V) f32 and {"self": each layer's dense cache of
        ``s_max`` slots (default S), "cross": each layer's cross K/V}."""
        tokens = batch["tokens"]
        kvs = self._cross_kvs(self.encode(batch["src_embed"]))
        x = self._embed(tokens)
        caches = []
        for blk, kv in zip(self.dec_blocks, kvs):
            x, c = dec_block_prefill(blk, x, kv, self.cfg,
                                     s_max or tokens.shape[1])
            caches.append(c)
        x = self.dec_norm(x[:, -1:])
        return self.logits(x), {"self": caches, "cross": kvs}

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: Caches,
                    idx: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
        """token (B, 1); idx (B,) int32 positions. The self caches are
        updated in place."""
        x = self._embed(token)
        for blk, c, kv in zip(self.dec_blocks, caches["self"],
                              caches["cross"]):
            x, _ = dec_block_decode(blk, x, c, kv, idx, self.cfg)
        return self.logits(self.dec_norm(x)), caches

    def init_cache(self, batch: int, s_max: int) -> Caches:
        """Empty caches: dense self caches of ``s_max`` slots, cross K/V of
        ``max_source_len`` frames."""
        cfg, dtype = self.cfg, self.rt.dtype
        T = cfg.encoder.max_source_len
        shape = (batch, T, cfg.num_kv_heads, cfg.resolved_head_dim)
        zeros = lambda: torch.zeros(shape, dtype=dtype, device=self.device)
        return {"self": [attn.init_dense_cache(cfg, batch, s_max, dtype,
                                               self.device)
                         for _ in range(cfg.num_layers)],
                "cross": [{"k": zeros(), "v": zeros()}
                          for _ in range(cfg.num_layers)]}
