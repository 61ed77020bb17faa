"""Mesh construction for the launchers. Counterpart of
``repro/launch/mesh.py``.

:func:`make_debug_mesh` is JAX's 2 x 4 ``data`` x ``model`` debug mesh on
the ranks of a :func:`repro_torch.launch.ranks.run_ranks` world (every rank
calls it with the world group it was given). The production meshes (256
chips, 512 across two pods) need a launcher that starts ranks on many
hosts, which the port does not have: :func:`make_production_mesh` raises.
"""
from __future__ import annotations

from repro_torch.sharding import Mesh, TPGroup, init_mesh

DEBUG_SHAPE = (2, 4)        # (data, model)


def make_debug_mesh(world: TPGroup, data: int = 2, model: int = 4) -> Mesh:
    """The ``data`` x ``model`` debug mesh (a flat TP ring of ``model``
    ranks in each of ``data`` replicas) over ``world``, which must hold
    data·model ranks."""
    if world.size != data * model:
        raise ValueError(f"the debug mesh is {data} x {model} ranks; the "
                         f"world has {world.size}")
    return init_mesh(world, dp=data)


def make_production_mesh(*, multi_pod: bool = False):
    """JAX's 16 x 16 (or 2 x 16 x 16) production mesh: not ported."""
    chips = 512 if multi_pod else 256
    raise NotImplementedError(
        f"the {'multi' if multi_pod else 'single'}-pod production mesh "
        f"({chips} ranks) needs a launcher that starts ranks on many hosts, "
        "which the port does not have; run --mesh debug on one host")
