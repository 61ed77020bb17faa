"""The process groups of the port: the TP ring and the device mesh.

Counterpart of ``repro/sharding.py``. One process a rank; JAX's ``shard_map``
bodies become per-rank code on a :class:`TPGroup`: ``lax.axis_index`` is
:attr:`TPGroup.rank`, ``lax.ppermute`` is :meth:`TPGroup.ppermute` (one
``batch_isend_irecv``), ``lax.all_gather``/``psum_scatter``/``psum`` along a
dimension are :meth:`all_gather`/:meth:`reduce_scatter`/:meth:`all_reduce`,
and ``lax.all_to_all`` over a leading axis of the ring's size is
:meth:`all_to_all`.

The group runs on NCCL when every rank has its own GPU and on gloo
otherwise. Gloo moves host memory only, so with gloo a CUDA tensor is
staged through the host on its way (``staged`` says so); the compute stays
on the card.

A mesh (:func:`init_mesh`) factors the world into a ``data`` axis and the
TP axes: a flat ``model`` ring (JAX's ``make_mesh((dp, tp), ("data",
"model"))``) or the hierarchical ``tp_in`` x ``tp_out`` pair (JAX's
``make_tp_mesh``: a fast intra-node ring times a slow inter-node axis).
The rank layout is JAX's: global rank ``d·tp + i_in·tp_out + i_out``, and
the composite TP index ``i_in·tp_out + i_out``, tp_in major
(``shard_map_axis_index``). :class:`Mesh` holds the ``data`` axis and the
whole TP group, which on a 2D mesh is a :class:`CompositeGroup`: its rank
is the composite index, its monolithic collectives run over all
tp_in·tp_out ranks in that order (JAX's collectives over the ``("tp_in",
"tp_out")`` tuple), and it carries the ``tp_in`` and ``tp_out`` rings that
the backends' hierarchical compositions run on
(:mod:`repro_torch.core.backends`).

The ``auto`` TP mode runs the one-device code on DTensors
(:mod:`torch.distributed.tensor`) over a 1-D ``DeviceMesh`` of a TP group
(:meth:`TPGroup.device_mesh`), :func:`shard` standing in for JAX's
``sharding.shard`` constraint. DTensor issues its collectives as the
functional ops (``torch.ops._c10d_functional``), which crash on CUDA
tensors over gloo; on a gloo group the mesh's CUDA collectives are staged
through the host instead (:func:`stage_functional_collectives`), as every
other hop of a gloo group is.
"""
from __future__ import annotations

from dataclasses import dataclass
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
    """This rank's view of one ring (a mesh axis): its rank, the ring size,
    and the collectives along one tensor dimension. ``pg`` is the process
    group (``None`` for a ring of one, where every collective is the
    identity); ``ranks`` are the members' global ranks in group order (the
    peers of point-to-point ops are global ranks on any group)."""

    def __init__(self, rank: int, size: int, backend: str, pg=None,
                 ranks: Optional[Sequence[int]] = None):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.rank, self.size, self.backend, self.pg = rank, size, backend, pg
        self.ranks = tuple(range(size) if ranks is None else ranks)
        self._meshes = {}

    def __repr__(self) -> str:
        return (f"TPGroup(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r})")

    def staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through host memory on the wire (gloo carries
        host memory only)."""
        return self.backend == "gloo" and x.device.type == "cuda"

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        return x.detach().cpu() if self.staged(x) else x.contiguous()

    def device_mesh(self, device_type: str):
        """The 1-D ``DeviceMesh`` of this group's process group for tensors
        on ``device_type`` (the ``auto`` mode's DTensors), made once a
        device type; a 2D mesh's composite group is one flat mesh over its
        composite index, the index its weights split over. On a gloo group
        the CUDA collectives go through the host
        (:func:`stage_functional_collectives`). Every rank makes it after
        its process group exists."""
        if device_type not in self._meshes:
            from torch.distributed.device_mesh import DeviceMesh

            if self.pg is None:
                raise ValueError(f"{self!r} has no process group to make a "
                                 "device mesh of")
            if self.backend == "gloo" and device_type == "cuda":
                stage_functional_collectives()
            self._meshes[device_type] = DeviceMesh.from_group(self.pg,
                                                              device_type)
        return self._meshes[device_type]

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
                ops.append(dist.P2POp(dist.isend, wire, self.ranks[dst[0]],
                                      self.pg, tag))
            if src:
                ops.append(dist.P2POp(dist.irecv, recv, self.ranks[src[0]],
                                      self.pg, tag))
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


class CompositeGroup(TPGroup):
    """The whole TP group of a 2D mesh: rank = the composite index
    ``i_in·tp_out + i_out``, size tp_in·tp_out, collectives over all its
    ranks in composite order; ``tp_in`` is this rank's tp_in ring and
    ``tp_out`` its tp_out ring."""

    def __init__(self, rank: int, size: int, backend: str, pg,
                 ranks: Sequence[int], tp_in: TPGroup, tp_out: TPGroup):
        super().__init__(rank, size, backend, pg, ranks)
        self.tp_in, self.tp_out = tp_in, tp_out

    def __repr__(self) -> str:
        return (f"CompositeGroup(rank={self.rank}, tp_in={self.tp_in.size}, "
                f"tp_out={self.tp_out.size}, backend={self.backend!r})")


def shard(x, mesh, seq_sharded: bool):
    """JAX's ``sharding.shard(x, BATCH_AXES, _sp_axis(rt, x), None)`` on a
    (B, S, d) DTensor ``x``: redistributed to its sequence shard
    (``Shard(1)``) where ``seq_sharded``, else whole on every rank
    (``Replicate()``). From a ``Partial`` sum that is one reduce-scatter or
    one all-reduce."""
    from torch.distributed.tensor import Replicate, Shard

    return x.redistribute(mesh, [Shard(1) if seq_sharded else Replicate()])


# ----- DTensor's collectives on CUDA tensors over gloo -----------------------


def _staged(group_name, x: torch.Tensor):
    """(the process group ``group_name`` names, ``x`` as it goes on the
    wire: in host memory on a gloo group)."""
    from torch._C._distributed_c10d import _resolve_process_group

    pg = group_name if isinstance(group_name, dist.ProcessGroup) \
        else _resolve_process_group(group_name)
    on_host = dist.get_backend(pg) == "gloo"
    return pg, (x.detach().cpu() if on_host else x).contiguous()


def _staged_all_gather(x, group_size, group_name):
    pg, wire = _staged(group_name, x)
    out = wire.new_empty((group_size * wire.shape[0], *wire.shape[1:]))
    _all_gather_single(out, wire, group=pg)
    return out.to(x.device)


def _staged_reduce_scatter(x, reduce_op, group_size, group_name):
    pg, wire = _staged(group_name, x)
    out = wire.new_empty((wire.shape[0] // group_size, *wire.shape[1:]))
    _reduce_scatter_single(out, wire, op=getattr(dist.ReduceOp,
                                                 reduce_op.upper()), group=pg)
    return out.to(x.device)


def _staged_all_reduce(x, reduce_op, group_name):
    pg, wire = _staged(group_name, x)
    out = wire.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, reduce_op.upper()),
                    group=pg)
    return out.to(x.device)


# the functional collectives the auto route's DTensors issue
STAGED_OPS = {"all_gather_into_tensor": _staged_all_gather,
              "reduce_scatter_tensor": _staged_reduce_scatter,
              "all_reduce": _staged_all_reduce}
_STAGED_LIBS = {}


def stage_functional_collectives(dispatch_key: str = "CUDA") -> None:
    """Run the functional collectives DTensor issues (:data:`STAGED_OPS`)
    on ``dispatch_key`` tensors as the c10d calls that gloo carries: the
    input copied to the host, the collective over the group's gloo
    backend, the result copied back (on a non-gloo group the same call on
    the device). The functional ops' own kernels crash on CUDA tensors
    over gloo (a SIGSEGV in ``wait_tensor``, torch 2.11 on an H100), while
    the c10d calls work; the result is complete when returned, so the op's
    ``wait_tensor`` finds nothing to wait for. Once a process and key;
    ``"CPU"`` runs the same staging on the CPU, as the tests do."""
    if dispatch_key in _STAGED_LIBS:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in STAGED_OPS.items():
        lib.impl(name, fn, dispatch_key)
    _STAGED_LIBS[dispatch_key] = lib


@dataclass(frozen=True)
class Mesh:
    """This rank's groups on a ``data`` x TP mesh: the ``data`` axis, ``tp``
    the whole TP group (a :class:`CompositeGroup` on a 2D mesh, which holds
    the ``tp_in`` and ``tp_out`` rings), ``world`` every rank. ``tp_in``
    and ``tp_out`` read the rings; on a flat mesh ``tp_in`` is the whole
    TP ring and ``tp_out`` a ring of one."""

    data: TPGroup
    tp: TPGroup
    world: TPGroup

    @property
    def is_2d(self) -> bool:
        return isinstance(self.tp, CompositeGroup)

    @property
    def tp_in(self) -> TPGroup:
        return self.tp.tp_in if self.is_2d else self.tp

    @property
    def tp_out(self) -> TPGroup:
        return self.tp.tp_out if self.is_2d else TPGroup(0, 1, "none")


def as_mesh(group) -> Optional[Mesh]:
    """``group`` as a :class:`Mesh`: a flat TP ring is a mesh with data
    axis 1; None stays None."""
    if group is None or isinstance(group, Mesh):
        return group
    return Mesh(data=TPGroup(0, 1, "none"), tp=group, world=group)


def tp_axes(mesh: Optional[Mesh]):
    """The TP group of ``mesh`` (JAX's ``tp_axes``: the composite group on a
    2D mesh, the flat ring otherwise); None without a mesh."""
    mesh = as_mesh(mesh)
    return None if mesh is None else mesh.tp


def tp_size(mesh: Optional[Mesh]) -> int:
    """Total TP degree: the flat ring's size, or tp_in·tp_out."""
    mesh = as_mesh(mesh)
    return 1 if mesh is None else mesh.tp.size


def dp_size(mesh: Optional[Mesh]) -> int:
    """The data axis's size (1 without one)."""
    mesh = as_mesh(mesh)
    return 1 if mesh is None else mesh.data.size


def _subgroup(world: TPGroup, member_lists, backend: str) -> TPGroup:
    """Every rank creates every group of ``member_lists`` (global ranks, in
    group order), in the same order, as torch.distributed requires; returns
    this rank's. Groups of one need no process group."""
    mine = None
    for members in member_lists:
        members = list(members)
        pg = None
        if len(members) > 1:
            pg = (world.pg if len(members) == world.size
                  else dist.new_group(members, backend=backend))
        if world.rank in members:
            mine = TPGroup(members.index(world.rank), len(members),
                           backend if pg is not None else "none", pg,
                           members)
    return mine


def init_mesh(world: TPGroup, *, dp: int = 1, tp_in: Optional[int] = None,
              tp_out: Optional[int] = None) -> Mesh:
    """Factor the ``world`` group (from :func:`init_tp_group`) into a mesh:
    ``data`` of ``dp`` and the TP axes of ``world.size // dp`` ranks, a flat
    ``model`` ring when ``tp_in`` and ``tp_out`` are both None (JAX's
    ``make_mesh((dp, tp), ("data", "model"))``), else the 2D ``tp_in`` x
    ``tp_out`` pair (JAX's ``make_tp_mesh(tp_in, tp_out, dp)``; one of the
    two may be None and is then the rest of the TP degree). Global rank
    ``d·tp + i_in·tp_out + i_out``. Every rank of ``world`` must call it
    with the same arguments."""
    n = world.size
    if dp < 1 or n % dp:
        raise ValueError(f"a data axis of {dp} does not divide {n} ranks")
    tp = n // dp
    two_d = tp_in is not None or tp_out is not None
    if tp_in is None:
        tp_in = tp // (tp_out or 1)
    if tp_out is None:
        tp_out = tp // tp_in
    if tp_in * tp_out != tp:
        raise ValueError(f"tp_in {tp_in} x tp_out {tp_out} != the TP degree "
                         f"{tp} of {n} ranks over data {dp}")
    be = world.backend
    g = lambda d, i, o: d * tp + i * tp_out + o     # noqa: E731
    data = _subgroup(world, [[g(d, i, o) for d in range(dp)]
                             for i in range(tp_in) for o in range(tp_out)], be)
    whole = _subgroup(world, [[g(d, i, o) for i in range(tp_in)
                               for o in range(tp_out)] for d in range(dp)], be)
    if two_d:
        inner = _subgroup(world, [[g(d, i, o) for i in range(tp_in)]
                                  for d in range(dp) for o in range(tp_out)],
                          be)
        outer = _subgroup(world, [[g(d, i, o) for o in range(tp_out)]
                                  for d in range(dp) for i in range(tp_in)],
                          be)
        whole = CompositeGroup(whole.rank, whole.size, whole.backend,
                               whole.pg, whole.ranks, inner, outer)
    return Mesh(data=data, tp=whole, world=world)


def init_tp_group(world: int, rank: int, *, init_method: str,
                  backend: Optional[str] = None,
                  device=None) -> TPGroup:
    """Join the ``world``-rank group as ``rank``: the flat TP ring over
    every rank, which :func:`init_mesh` factors into a mesh.
    ``init_method`` is the rendezvous (``file://<path>`` or
    ``tcp://localhost:<port>``). ``backend=None`` picks NCCL when every
    rank can have its own GPU (the device is CUDA and the host has
    ``world`` of them) and gloo otherwise."""
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
