"""Parameters from the JAX package into the port.

The two packages draw different random numbers from one seed, so a parity
check initialises ``repro``'s model, converts its parameter pytree to numpy
(nested dicts/lists of arrays) and loads it here. No weights are ever
downloaded.

Layer order: ``repro`` stacks the blocks of its full pattern periods on a
leading axis (``stack["periods"]["b{i}"]``, one slice per period) and keeps
the ``num_layers % len(layer_pattern)`` trailing blocks in
``stack["rem"]``. Period ``p``'s block ``b{i}`` is layer ``p * P + i``, and
``rem[j]`` is layer ``n_full * P + j``. Both layouts keep weights as
``(d_in, d_out)``, so nothing is transposed.

The VLM's tree is the LM's plus ``vision_proj``. The enc-dec tree stacks
every encoder block on one leading axis (``enc_blocks``) and every decoder
block on another (``dec_blocks``); block ``i`` is slice ``i``, and the
decoder block's ``"self"`` attention is the port's ``self_attn``.

For a model on a TP group (a flat ring or a 2D mesh's composite group),
:func:`shard_for_group` keeps this rank's slice of each TP weight, by the
specs of the period-graph fragment: the TP weights by the (composite)
index, an MoE's experts by whole expert over tp_out on a 2D mesh (grouped
EP, :func:`repro_torch.core.tp.param_placement`). JAX's parameter store
splits a grouped expert's hidden dimension over tp_in instead
(``repro/launch/specs.py``); the values are the same (ROADMAP C).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig

Tree = Any   # nested dicts/lists with numpy leaves


def _slice(tree: Mapping, p: int) -> Tree:
    """Period ``p`` of a tree of stacked arrays."""
    return {k: _slice(v, p) if isinstance(v, Mapping) else np.asarray(v)[p]
            for k, v in tree.items()}


def unstack_layers(stack: Mapping, cfg: ArchConfig) -> List[Tree]:
    """``repro``'s stacked ``{"periods", "rem"}`` layout (parameters or KV
    pools) -> one subtree per layer, in layer order."""
    P = len(cfg.layer_pattern)
    n_full = cfg.num_layers // P
    layers: List[Tree] = [None] * cfg.num_layers
    for i in range(P if n_full else 0):
        stacked = stack["periods"][f"b{i}"]
        for p in range(n_full):
            layers[p * P + i] = _slice(stacked, p)
    for j, tree in enumerate(stack["rem"]):
        layers[n_full * P + j] = tree
    if any(t is None for t in layers):
        raise ValueError(f"stack does not hold {cfg.num_layers} layers")
    return layers


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v


def _tensor(a) -> torch.Tensor:
    # bf16 arrays (ml_dtypes) go through f32, which holds them exactly
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a writable copy


def _encdec_flat(params: Mapping, cfg: ArchConfig,
                 flat: Dict[str, np.ndarray]) -> None:
    for stack, n in (("enc_blocks", cfg.encoder.num_layers),
                     ("dec_blocks", cfg.num_layers)):
        for li in range(n):
            block = _slice(params[stack], li)
            if "self" in block:
                block["self_attn"] = block.pop("self")
            _flatten(block, f"{stack}.{li}.", flat)
    _flatten(params["enc_norm"], "enc_norm.", flat)
    _flatten(params["dec_norm"], "dec_norm.", flat)


def state_dict_from_jax(params: Mapping, cfg: ArchConfig
                        ) -> Dict[str, torch.Tensor]:
    """``repro``'s model pytree (``LM.init``, ``VLM.init`` or
    ``EncDecLM.init``) -> the port's state dict of the same model."""
    flat: Dict[str, np.ndarray] = {"embed": params["embed"]}
    if cfg.is_enc_dec:
        _encdec_flat(params, cfg, flat)
        return {k: _tensor(v) for k, v in flat.items()}
    for li, block in enumerate(unstack_layers(params["stack"], cfg)):
        _flatten(block, f"blocks.{li}.", flat)
    _flatten(params["final_norm"], "final_norm.", flat)
    for extra in ("lm_head", "vision_proj"):
        if extra in params:
            flat[extra] = params[extra]
    return {k: _tensor(v) for k, v in flat.items()}


def shard_for_group(sd: Mapping[str, torch.Tensor], cfg: ArchConfig,
                    group) -> Dict[str, torch.Tensor]:
    """This rank's state dict on the TP group ``group`` (a flat ring or a
    2D mesh's composite group; None or a group of one keeps it whole), by
    :func:`repro_torch.core.tp.param_placement`."""
    from repro_torch.core.tp import shard_param

    return {name: shard_param(t, name, cfg, group).contiguous()
            for name, t in sd.items()}


def load_jax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy ``repro`` parameters (numpy pytree) into the port's model (an
    ``LM``, ``VLM`` or ``EncDecLM``), in its parameter type and on its
    device, sharded for its TP rank; every key must match."""
    sd = shard_for_group(state_dict_from_jax(params, model.cfg), model.cfg,
                         model.group)
    own = model.state_dict()
    missing, extra = own.keys() - sd.keys(), sd.keys() - own.keys()
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {sorted(missing)}, "
                       f"unexpected {sorted(extra)}")
    for name, t in sd.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(own[name].shape)}")
    model.load_state_dict(sd)
