"""The tensor-parallel process group of the port.

Counterpart of ``repro/sharding.py`` for the one mesh the port runs: a flat
``model`` ring of ``size`` ranks, one process each. JAX's ``shard_map``
bodies become per-rank code on a :class:`TPGroup`: ``lax.axis_index`` is
:attr:`TPGroup.rank`, ``lax.ppermute`` is :meth:`TPGroup.ppermute` (one
``batch_isend_irecv``), ``lax.all_gather``/``psum_scatter``/``psum`` along a
dimension are :meth:`all_gather`/:meth:`reduce_scatter`/:meth:`all_reduce`,
and ``lax.all_to_all`` over a leading axis of the ring's size is
:meth:`all_to_all`.

The group runs on NCCL when every rank has its own GPU and on gloo
otherwise. Gloo moves host memory only, so with gloo a CUDA tensor is
staged through the host on its way (``staged`` says so); the compute stays
on the card. A data-parallel axis or a 2D (``tp_in`` x ``tp_out``) mesh is
ROADMAP A14 and raises.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

Perm = Sequence[Tuple[int, int]]

# the single-tensor collectives under their current names, with the older
# names where this torch lacks them (the signatures are the same)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class TPGroup:
    """This rank's view of the TP ring: its rank, the ring size, and the
    collectives along one tensor dimension. ``pg`` is the process group
    (``None`` for a ring of one, where every collective is the identity)."""

    def __init__(self, rank: int, size: int, backend: str, pg=None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.rank, self.size, self.backend, self.pg = rank, size, backend, pg

    def __repr__(self) -> str:
        return (f"TPGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")

    def staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through host memory on the wire (gloo carries
        host memory only)."""
        return self.backend == "gloo" and x.device.type == "cuda"

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().cpu() if self.staged(x) else x.contiguous()

    # ----- point to point -----
    def ppermute_many(self, xs: Sequence[torch.Tensor],
                      perms: Sequence[Perm]) -> List[torch.Tensor]:
        """``lax.ppermute`` of each ``xs[k]`` by ``perms[k]`` (pairs
        (source, destination)), all in one ``batch_isend_irecv``. A rank that
        no pair sends to receives zeros, as in JAX."""
        if self.size == 1:
            return [x.clone() for x in xs]
        ops, outs = [], []
        for tag, (x, perm) in enumerate(zip(xs, perms)):
            dst = [d for s, d in perm if s == self.rank]
            src = [s for s, d in perm if d == self.rank]
            wire = self._wire(x)
            recv = torch.zeros_like(wire)
            if dst:
                ops.append(dist.P2POp(dist.isend, wire, dst[0], self.pg,
                                      tag))
            if src:
                ops.append(dist.P2POp(dist.irecv, recv, src[0], self.pg,
                                      tag))
            outs.append(recv)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [r.to(x.device) for r, x in zip(outs, xs)]

    def ppermute(self, x: torch.Tensor, perm: Perm) -> torch.Tensor:
        return self.ppermute_many([x], [perm])[0]

    # ----- collectives along one dimension -----
    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` in rank order
        (``lax.all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        wire = self._wire(x.movedim(dim, 0))
        out = wire.new_empty((self.size * wire.shape[0], *wire.shape[1:]))
        _all_gather_single(out, wire.contiguous(), group=self.pg)
        return out.to(x.device).movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over ranks, then keep this rank's slice of ``dim``
        (``lax.psum_scatter(..., tiled=True)``)."""
        if self.size == 1:
            return x
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks")
        wire = self._wire(x.movedim(dim, 0)).contiguous()
        out = wire.new_empty((wire.shape[0] // self.size, *wire.shape[1:]))
        _reduce_scatter_single(out, wire, group=self.pg)
        return out.to(x.device).movedim(0, dim).contiguous()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Row ``j`` of ``x`` (leading axis of the ring's size) to rank
        ``j``; row ``j`` of the result is what rank ``j`` sent this rank
        (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``)."""
        if self.size == 1:
            return x
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading axis of "
                             f"{self.size}, got {tuple(x.shape)}")
        wire = self._wire(x).contiguous()
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.pg)
        return out.to(x.device)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (``lax.psum``); returns a new tensor."""
        if self.size == 1:
            return x
        wire = self._wire(x).clone()
        dist.all_reduce(wire, group=self.pg)
        return wire.to(x.device)


def init_tp_group(world: int, rank: int, *, init_method: str,
                  backend: Optional[str] = None, dp: int = 1,
                  device=None) -> TPGroup:
    """Join the ``world``-rank TP ring as ``rank``. ``init_method`` is the
    rendezvous (``file://<path>`` or ``tcp://localhost:<port>``).
    ``backend=None`` picks NCCL when every rank can have its own GPU (the
    device is CUDA and the host has ``world`` of them) and gloo otherwise."""
    if dp != 1:
        raise NotImplementedError("a data-parallel axis or a 2D mesh is not "
                                  "ported yet (ROADMAP A14); the port runs "
                                  "one flat TP ring")
    if world == 1:
        return TPGroup(0, 1, "none")
    if backend is None:
        on_card = device is not None and torch.device(device).type == "cuda"
        backend = "nccl" if on_card and \
            torch.cuda.device_count() >= world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank)           # one card per rank
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return TPGroup(rank, world, backend, dist.group.WORLD)


def destroy_tp_group(group: TPGroup) -> None:
    if group.pg is not None and dist.is_initialized():
        dist.destroy_process_group()
