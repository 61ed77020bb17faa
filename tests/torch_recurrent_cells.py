"""Per-rank body of ``tests/test_torch_recurrent_tp.py``, run on every rank
of a gloo ring by ``repro_torch.launch.ranks.run_ranks``: ``LM.loss``, its
backward and ``sync_grads`` for the recurrent families, whose mixers run
replicated on the ring (``tests/torch_sublayer_cells.py``'s ``lm_cells``).
Imports torch, numpy and ``repro_torch`` only, so the rank processes never
import JAX."""
from __future__ import annotations

import sys

from torch_sublayer_cells import _counters, lm_cells


def recurrent_cells(group, cases):
    """{"lm": lm_cells of ``cases``, "_jax_imported": whether JAX was
    imported on this rank}."""
    out = {"lm": lm_cells(group, cases, _counters())}
    out["_jax_imported"] = "jax" in sys.modules
    return out
