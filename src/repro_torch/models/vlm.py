"""Prefix-LM VLM (paligemma-3b), the counterpart of ``repro/models/vlm.py``.

The SigLIP vision tower is a stub, as in JAX: the inputs carry precomputed
patch embeddings ``(B, num_prefix_tokens, vision_width)``; this module owns
the projection into the LM width (``vision_proj``) and the prefix-LM mask,
bidirectional attention among the image-prefix positions.

:class:`VLM` is an :class:`repro_torch.models.transformer.LM` with
``vision_proj`` beside the decoder's parameters, so the decoder's state
dict, its TP shards and its period graphs are the LM's. ``loss`` runs the
stack with ``prefix_len = P`` and the cross-entropy over the text rows; on a
TP ring in the ``"sharded"`` layout each rank's rows are its shard of the
P + S rows, the prefix rows unlabelled (``LM._loss``). ``prefill`` runs the
image prefix and the prompt through the stack CAUSALLY, as JAX's
``VLM.prefill`` does (it calls ``stack_prefill`` without ``prefix_len``):
JAX serves with a different mask from the one it trains with, and the port
follows it in both (ROADMAP C). Decode is the LM's, positions counted from
the image prefix's first token.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import dense_init_
from repro_torch.models.transformer import LM
from repro_torch.runtime import Runtime


class VLM(LM):
    """Image-prefix + text decoder; ``vision_proj`` (vision_width, d)."""

    def __init__(self, cfg: ArchConfig, rt: Runtime = Runtime(), *,
                 device=None, seed: Optional[int] = 0, group=None):
        if cfg.num_prefix_tokens <= 0:
            raise ValueError(f"{cfg.name} has no image prefix "
                             "(num_prefix_tokens 0): build an LM")
        super().__init__(cfg, rt, device=device, seed=seed, group=group)

    def _extra_params(self, param) -> None:
        self.vision_proj = param(self.cfg.vision_width, self.cfg.d_model)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        dense_init_(self.vision_proj, generator)

    def _embed_all(self, patch_embed: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
        """[patch_embed @ vision_proj, embed[tokens]]: (B, P + S, d) in the
        compute type."""
        dtype = self.rt.dtype
        img = patch_embed.to(dtype) @ self.vision_proj.to(dtype)
        return torch.cat([img, self._embed(tokens, dtype)], dim=1)

    def forward(self, tokens: torch.Tensor, patch_embed: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hidden states of the P + S rows after the final norm (this
        rank's shard of them on a TP ring in the ``"sharded"`` layout) and
        the aux loss; the image prefix attends bidirectionally."""
        return self._stack(self._embed_all(patch_embed, tokens),
                           self.cfg.num_prefix_tokens)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token cross-entropy over the text of ``batch``
        ({"patch_embed" (B, P, vision_width), "tokens", "labels"[,
        "mask"]}, each (B, S)) + the weighted aux loss."""
        x, aux = self.forward(batch["tokens"], batch["patch_embed"])
        return self._loss(x, aux, batch, self.cfg.num_prefix_tokens)

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                s_max: Optional[int] = None
                ) -> Tuple[torch.Tensor, List[attn.Cache]]:
        """The image prefix and the prompt ({"patch_embed", "tokens"})
        through the stack, causally over all P + S positions (JAX's
        ``VLM.prefill``); caches of ``s_max`` slots (default P + S). Decode
        steps continue at position P + S."""
        x = self._embed_all(batch["patch_embed"], batch["tokens"])
        return super().prefill(embeds=x, s_max=s_max)

    def serve_step(self, tokens, pools, view):
        raise NotImplementedError(
            f"{self.cfg.name}: the VLM has no paged path (its prefill takes "
            "the image prefix); serve it through the dense engine")
