"""Mesh axes over ``torch.distributed`` process groups.

Counterpart of the reference's mesh (``parallel/sharding.py::make_mesh``,
:57) and of the collectives its ``shard_map`` bodies call on a named axis
(``lax.all_gather``, ``lax.all_to_all``, ``lax.psum``, ``lax.axis_index``).
A ``Mesh`` lays the ranks of the world out row-major over named axes, as
the reference lays devices out (``{"data": d, "points": p}``: rank ``i * p
+ j`` is data row ``i``, points column ``j``); each ``Axis`` is this rank's
row (or column) of the mesh: a process group with its ``rank`` and ``size``.

How a collective moves data is the backend's business, read from its name:
NCCL moves CUDA tensors between cards; gloo moves CPU tensors, and a CUDA
tensor on a gloo axis (ranks that share one card) goes through pinned host
memory: copied down, exchanged, copied back.  ``Axis.staging`` names the
choice; it is never made by catching an error.

Every axis counts what it moves: ``bytes`` (this rank's share sent into
each collective), ``calls``, and ``host_reads`` (the device-to-host copies
that staging made, each of which waits for the stream).
"""

from __future__ import annotations

import datetime
import math

import torch
import torch.distributed as dist

__all__ = ["Axis", "Mesh", "make_mesh", "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 300.0  # a process group's collectives fail after this long


class Axis:
    """One mesh axis as seen from this rank: a process group of ``size``
    ranks in which this one is ``rank`` (the reference's ``axis_index``)."""

    def __init__(self, name: str, group, ranks: list[int]):
        self.name = name
        self.group = group
        self.ranks = list(ranks)  # world ranks of the axis, in axis order
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.backend = dist.get_backend(group) if group is not None else "none"
        # gloo carries host tensors: a CUDA tensor goes through pinned memory
        self.staging = "pinned host" if self.backend == "gloo" else "none"
        self.bytes = 0
        self.calls = 0
        self.host_reads = 0

    def reset_counts(self) -> None:
        self.bytes = self.calls = self.host_reads = 0

    # ---- data movement --------------------------------------------------
    def _down(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend can take it (contiguous)."""
        t = t.contiguous()
        if self.staging == "none" or not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()  # the copy has landed
        self.host_reads += 1
        return host

    def _host_like(self, src: torch.Tensor, shape, t: torch.Tensor) -> torch.Tensor:
        """An output buffer beside ``src``: pinned where it goes back up."""
        staged = self.staging != "none" and t.is_cuda
        return torch.empty(shape, dtype=src.dtype, device=src.device, pin_memory=staged)

    @staticmethod
    def _up(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return t.to(like.device, non_blocking=True) if like.is_cuda and not t.is_cuda else t

    def _count(self, t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in axis order (the
        reference's tiled ``all_gather``)."""
        if self.size == 1:
            return t
        src = self._down(t)
        self._count(src)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        shape = list(src.shape)
        shape[dim] *= self.size
        out = self._host_like(src, shape, t)
        torch.cat(parts, dim=dim, out=out)
        return self._up(out, t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [size, ...]: row r goes to rank r; returns [size, ...], row
        s from rank s (the reference's untiled ``all_to_all`` with
        ``split_axis = concat_axis`` = the leading axis)."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: leading dim {t.shape[0]} != axis size {self.size}")
        if self.size == 1:
            return t
        src = self._down(t)
        self._count(src)
        out = self._host_like(src, src.shape, t)
        dist.all_to_all_single(out, src, group=self.group)
        return self._up(out, t)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``t`` (integer tensors here:
        exact in any order)."""
        if self.size == 1:
            return t
        src = self._down(t).clone()
        self._count(src)
        dist.all_reduce(src, op=dist.ReduceOp.SUM, group=self.group)
        return self._up(src, t)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """The elementwise OR of every rank's boolean ``flag``."""
        return self.psum(flag.to(torch.int32)) > 0

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Axis rank ``src``'s ``t`` on every rank."""
        if self.size == 1:
            return t
        buf = self._down(t).clone()
        self._count(buf)
        dist.broadcast(buf, src=self.ranks[src], group=self.group)
        return self._up(buf, t)


class Mesh:
    """Named axes over a row-major layout of ranks (the reference's
    ``jax.sharding.Mesh``): ``axes[name]`` is this rank's ``Axis``."""

    def __init__(self, axis_sizes: dict[str, int], axes: dict[str, Axis]):
        self.axis_sizes = dict(axis_sizes)
        self.axes = axes

    def __getitem__(self, name: str) -> Axis:
        return self.axes[name]

    def reset_counts(self) -> None:
        for a in self.axes.values():
            a.reset_counts()

    def counts(self) -> dict:
        """Bytes, calls and host reads summed over the axes."""
        return {k: sum(getattr(a, k) for a in self.axes.values())
                for k in ("bytes", "calls", "host_reads")}


def make_mesh(axis_sizes: dict[str, int], ranks: list[int] | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh | None:
    """A ``Mesh`` of ``axis_sizes`` over world ranks ``ranks`` (by default
    the whole world), laid out row-major.  Every rank of the world must
    call it with the same arguments: the process groups of every axis are
    made in one order on all of them (``dist.new_group`` is collective).
    Returns None on a rank outside ``ranks``."""
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    total = math.prod(axis_sizes.values())
    if total != len(ranks):
        raise ValueError(f"mesh wants {total} ranks, have {len(ranks)}")
    names = list(axis_sizes)
    sizes = [axis_sizes[k] for k in names]
    grid = torch.arange(total).reshape(sizes)  # mesh position -> index into ranks
    me = dist.get_rank()
    timeout = datetime.timedelta(seconds=timeout_s)
    axes = {}
    for d, name in enumerate(names):
        # the lines of the grid along axis d, one process group each
        lines = grid.movedim(d, -1).reshape(-1, sizes[d])
        for line in lines.tolist():
            members = [ranks[i] for i in line]
            group = dist.new_group(members, timeout=timeout) if len(members) > 1 else None
            if me in members:
                axes[name] = Axis(name, group, members)
    return Mesh(axis_sizes, axes) if me in ranks else None
