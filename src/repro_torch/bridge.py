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


def state_dict_from_jax(params: Mapping, cfg: ArchConfig
                        ) -> Dict[str, torch.Tensor]:
    """``repro``'s ``LM.init`` pytree -> the port's ``LM`` state dict."""
    flat: Dict[str, np.ndarray] = {"embed": params["embed"]}
    for li, block in enumerate(unstack_layers(params["stack"], cfg)):
        _flatten(block, f"blocks.{li}.", flat)
    _flatten(params["final_norm"], "final_norm.", flat)
    if "lm_head" in params:
        flat["lm_head"] = params["lm_head"]
    return {k: _tensor(v) for k, v in flat.items()}


def load_jax_params(model: torch.nn.Module, params: Mapping) -> None:
    """Copy ``repro`` parameters (numpy pytree) into the port's ``LM``, in
    its parameter type and on its device; every key must match."""
    sd = state_dict_from_jax(params, model.cfg)
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
