"""Per-rank body of ``tests/test_torch_vlm_tp.py``, run on every rank of a
gloo ring by ``repro_torch.launch.ranks.run_ranks``: the VLM's loss (the
image prefix attending bidirectionally inside the period graphs), its
backward and ``sync_grads`` over the P + S rows. Imports torch, numpy and
``repro_torch`` only, so the rank processes never import JAX."""
from __future__ import annotations

import sys

from torch_sublayer_cells import _counters, _np, _t


def vlm_cells(group, cases):
    """{(case, mode, mb, sequence_parallel): (loss, {param: this rank's
    grad}, the kernel calls made, the counts ``tp.step_launches`` derives,
    the prefix_len of every flash call), "_jax_imported": whether JAX was
    imported on this rank}."""
    from repro_torch import bridge
    from repro_torch.core import tp as tp_mod
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.transformer import activation_layout
    from repro_torch.runtime import SMOKE, Runtime, TPConfig

    count = _counters()
    prefixes = []
    inner = ops.flash_attention

    def recorded(*a, **kw):
        prefixes.append(kw.get("prefix_len", 0))
        return inner(*a, **kw)

    ops.flash_attention = recorded
    out = {}
    for label, (cfg, params, batch, runs) in cases.items():
        b = {k: _t(v) for k, v in batch.items()}
        B, S = batch["tokens"].shape
        T = cfg.num_prefix_tokens + S
        for mode, mb, sp in runs:
            rt = Runtime(compute_dtype="float32",
                         loss_chunk=SMOKE.loss_chunk, remat=False,
                         tp=TPConfig(mode=mode, chunks=2, microbatches=mb,
                                     sequence_parallel=sp))
            vlm = build_model(cfg, rt, device="cpu", seed=None, group=group)
            bridge.load_jax_params(vlm, params)
            vlm.requires_grad_(True)
            for k in count:
                count[k] = 0
            prefixes.clear()
            with tp_mod.recording() as rec:
                loss = vlm.loss(b)
            loss.backward()
            vlm.sync_grads(T)
            derived = tp_mod.step_launches(rec, B, T, cfg.d_model, 4)
            derived["layout"] = activation_layout(rt, T, group.size)
            out[(label, mode, mb, sp)] = (
                float(loss.detach()),
                {k: _np(p.grad) for k, p in vlm.named_parameters()},
                dict(count),
                {k: derived[k] for k in ("layout", "matmul", "flash")},
                list(prefixes))
    out["_jax_imported"] = "jax" in sys.modules
    return out
