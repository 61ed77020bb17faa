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

A train state crosses the same way (:func:`train_state_from_jax`, and
:func:`load_jax_checkpoint` for a directory ``repro.checkpoint`` wrote):
AdamW's moments are unstacked like the parameters; Adafactor's state stays
in JAX's leaves, as the port's Adafactor keeps it
(:class:`repro_torch.optim.optimizers.Leaf`, :func:`jax_leaf`).

For a model on a TP group (a flat ring or a 2D mesh's composite group),
:func:`shard_for_group` keeps this rank's slice of each TP weight, by the
specs of the period-graph fragment: the TP weights by the (composite)
index, an MoE's experts by whole expert over tp_out on a 2D mesh (grouped
EP, :func:`repro_torch.core.tp.param_placement`). JAX's parameter store
splits a grouped expert's hidden dimension over tp_in instead
(``repro/launch/specs.py``); the values are the same (ROADMAP C).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

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
    for j, tree in enumerate(stack.get("rem", ())):
        layers[n_full * P + j] = tree
    if any(t is None for t in layers):
        raise ValueError(f"stack does not hold {cfg.num_layers} layers")
    return layers


def jax_leaf(name: str, cfg: ArchConfig) -> Tuple[str, Optional[int]]:
    """The ``repro`` leaf that the port's parameter ``name`` belongs to, as
    its path joined by dots, and its index on that leaf's stacked leading
    axis (None for a leaf of its own), by :func:`unstack_layers`'s rule:
    layer ``p * P + i`` of a full period is ``stack.periods.b{i}`` at
    ``p``, a ``rem`` layer ``j`` is ``stack.rem.{j}``, an enc-dec block
    ``li`` is ``enc_blocks``/``dec_blocks`` at ``li`` (``self_attn`` is
    JAX's ``self``); the rest are leaves of their own."""
    head, _, rest = name.partition(".")
    if head in ("enc_blocks", "dec_blocks") and cfg.is_enc_dec:
        li, _, leaf = rest.partition(".")
        if leaf.startswith("self_attn."):
            leaf = "self." + leaf[len("self_attn."):]
        return f"{head}.{leaf}", int(li)
    if head != "blocks":
        return name, None
    li, _, leaf = rest.partition(".")
    P = len(cfg.layer_pattern)
    n_full = cfg.num_layers // P
    p, i = divmod(int(li), P)
    if p < n_full:
        return f"stack.periods.b{i}.{leaf}", p
    return f"stack.rem.{int(li) - n_full * P}.{leaf}", None


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):       # a checkpoint's bf16 leaf
        return a.clone()
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


def _factored_groups(tree, prefix: str, out: Dict[str, Dict]) -> None:
    """Adafactor's state tree (a ``{"vr", "vc"}`` or ``{"v"}`` dict at
    each leaf of the params tree) -> {JAX leaf joined by dots: its state}."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, Mapping) and v and set(v) <= {"vr", "vc", "v"}:
            out[name] = {s: _tensor(a) for s, a in v.items()}
        else:
            _factored_groups(v, name + ".", out)


def train_state_from_jax(state: Mapping, cfg: ArchConfig) -> Dict[str, Any]:
    """``repro``'s train state ``{"params", "opt", "step"}`` (numpy
    pytree) -> the port's, whole (one device): the parameters as
    :func:`state_dict_from_jax`, AdamW's ``m``/``v`` unstacked like them,
    Adafactor's state kept in JAX's groups ({leaf: {"vr", "vc"} or
    {"v"}}, :func:`jax_leaf`'s names), the step an int."""
    opt = state["opt"]
    if isinstance(opt, Mapping) and set(opt) == {"m", "v"}:
        opt = {k: state_dict_from_jax(opt[k], cfg) for k in ("m", "v")}
    else:
        groups: Dict[str, Dict] = {}
        _factored_groups(opt, "", groups)
        opt = groups
    return {"params": state_dict_from_jax(state["params"], cfg), "opt": opt,
            "step": int(np.asarray(state["step"]))}


def _tree_from_flat(flat: Mapping[str, Any], sep: str = "::") -> Dict:
    """Nested dicts from ``sep``-joined keys; a dict whose keys are all
    digits (``stack.rem``) becomes a list."""
    root: Dict = {}
    for key, a in flat.items():
        node, parts = root, key.split(sep)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[k] for k in sorted(node, key=int)]
        return node
    return lists(root)


def load_jax_checkpoint(ckpt_dir: str, cfg: ArchConfig,
                        step: Optional[int] = None) -> Dict[str, Any]:
    """The port's whole train state from a directory written by
    ``repro.checkpoint.store.save`` (the latest step unless ``step``): its
    ``manifest.json`` and ``arrays.npz`` read and verified
    (:func:`repro_torch.checkpoint.store.read`), the tree rebuilt from the
    ``::`` keys, then :func:`train_state_from_jax`. Load it into a train
    state with :func:`repro_torch.checkpoint.store.load_state` (which
    slices it for a TP rank)."""
    from repro_torch.checkpoint.store import read

    flat, _ = read(ckpt_dir, step)
    return train_state_from_jax(_tree_from_flat(flat), cfg)


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
