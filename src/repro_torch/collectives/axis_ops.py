"""Collectives over axes of a device mesh, with their transposes as
gradients: what the expert-parallel MoE and the sharded training step run
where the JAX package runs ``lax`` collectives inside a ``shard_map``.

An :class:`Axis` is one process group over one or several mesh axes (the
several taken major to minor, so group rank = the flattened coordinate,
as ``lax`` orders an axis tuple). Every message goes through
:class:`~repro_torch.collectives.tree_allreduce.Link`: under gloo a CUDA
tensor is staged through pinned host memory, under NCCL it goes card to
card. Only two exchanges are used, an all-gather and an all-to-all; every
sum is then taken on each rank over the G received parts in group rank
order, accumulated in float32 and rounded once to the input's dtype. So
every rank holds the same bits, the order of a sum does not depend on the
backend, and a bfloat16 sum is never asked of gloo.

The operations and their backward (each a ``torch.autograd.Function``):

  all_gather(x, axis, dim)           concatenation along ``dim`` in rank
                                     order; backward: reduce-scatter (the
                                     parts of the gradient summed)
  all_gather_invariant(x, axis)      the same along dim 0, for a result
                                     every rank then uses alike; backward:
                                     this rank's slice of the gradient
  own_slice(x, axis)                 this rank's 1/G of dim 0 of a value
                                     every rank holds alike; backward:
                                     all-gather of the gradient
  psum(x, axis)                      the sum (a reduce-scatter and an
                                     all-gather where G > 2 and x's
                                     values split into G chunks);
                                     backward: the identity
  pmean(x, axis)                     the mean; backward: scaled by 1/G
  varying(x, axis)                   the identity; backward: psum (JAX's
                                     ``pcast(..., to="varying")``)
  all_to_all(x, axis)                row i of (G, ...) to rank i; backward:
                                     the reverse all-to-all

On an axis of one rank each is the identity. ``exchange_log`` records
each exchange's bytes (and those staged through the host) and its
seconds, the device synchronised at both edges, while it is open.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from .tree_allreduce import Link

_LOG = threading.local()
_GROUPS: dict = {}


@dataclasses.dataclass(frozen=True)
class Axis:
    """A process group over mesh axes ``names``: its ``size`` ranks, this
    process's ``rank`` in it (the flattened coordinate)."""
    names: tuple
    group: Any
    size: int
    rank: int


def axis(mesh, names) -> Axis:
    """The group over ``names`` (a name or a tuple of names, in the mesh's
    order) of ``mesh``, a ``DeviceMesh``: the ranks that share every other
    coordinate with this one. Every rank of the mesh must make the same
    calls in the same order (creating a group is collective); groups are
    made once a process and mesh layout."""
    names = (names,) if isinstance(names, str) else tuple(names)
    all_names = tuple(mesh.mesh_dim_names)
    if not names:
        return Axis((), None, 1, 0)
    idx = [all_names.index(n) for n in names]
    if idx != sorted(idx):
        raise ValueError(f"axes {names} are not in the mesh's order "
                         f"{all_names}")
    with _disable_current_modes():      # host metadata, never a fake tensor
        ranks = mesh.mesh
        key = (tuple(ranks.shape), tuple(ranks.flatten().tolist()),
               all_names, names)
    if key not in _GROUPS:
        if len(names) == 1:
            group = mesh.get_group(names[0])
        else:
            rest = [i for i in range(ranks.ndim) if i not in idx]
            size = 1
            for i in idx:
                size *= ranks.shape[i]
            with _disable_current_modes():
                rows = ranks.permute(rest + idx).reshape(-1, size).tolist()
            group, _ = dist.new_subgroups_by_enumeration(rows)
        _GROUPS[key] = group
    group = _GROUPS[key]
    return Axis(names, group, dist.get_world_size(group),
                dist.get_rank(group))


def forget_groups() -> None:
    """Drop the groups :func:`axis` made: after the default process group
    is destroyed they are dead, and a new group of the same layout would
    find them (``launch.dryrun`` makes and destroys a group a cell)."""
    _GROUPS.clear()


# -- exchanges ----------------------------------------------------------------

@contextlib.contextmanager
def exchange_log():
    """Collect ``{"op", "axis", "bytes", "operand_bytes", "staged_bytes",
    "s"}`` for each exchange made while open: the bytes of its result and
    of its operand (what this rank sends) on this rank, those
    copied through pinned host memory (the input out and the result back;
    0 when not staged), its seconds with the device synchronised at both
    edges."""
    prev = getattr(_LOG, "records", None)
    _LOG.records = []
    try:
        yield _LOG.records
    finally:
        _LOG.records = prev


def _timed(op: str, ax: Axis, t: torch.Tensor, run):
    records = getattr(_LOG, "records", None)
    if records is None:
        return run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = run()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    sent = t.numel() * t.element_size()
    got = sent * ax.size if op == "all_gather" else sent
    staged = Link(ax.group, t.device).staged
    records.append({"op": op, "axis": ax.names, "bytes": got,
                    "operand_bytes": sent,
                    "staged_bytes": sent + got if staged else 0,
                    "s": time.perf_counter() - t0})
    return out


def _gather(x: torch.Tensor, ax: Axis) -> list[torch.Tensor]:
    return _timed("all_gather", ax, x,
                  lambda: Link(ax.group, x.device).all_gather(x))


def _exchange(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return _timed("all_to_all", ax, x,
                  lambda: Link(ax.group, x.device).all_to_all(x))


def ordered_sum(parts, dtype) -> torch.Tensor:
    """The parts summed in order, accumulated in float32, rounded once."""
    acc = parts[0].to(torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(torch.float32)
    return acc.to(dtype)


def _reduce_scatter(g: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Rank i gets the sum over ranks of their i-th chunk of ``g`` along
    ``dim``."""
    parts = torch.stack(g.chunk(ax.size, dim))
    got = _exchange(parts, ax)
    return ordered_sum(list(got), g.dtype)


# -- the differentiable operations -------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(_gather(x, ax), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.ax, ctx.dim), None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return torch.cat(_gather(x, ax))

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.ax.size)[ctx.ax.rank].contiguous(), None


class _OwnSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.chunk(ax.size)[ax.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather(g.contiguous(), ctx.ax)), None


def _sum_over(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the ranks of their ``x``, in rank order, accumulated in
    float32 and rounded once. Over more than two ranks, where ``x``'s
    values split into ``ax.size`` equal chunks, a reduce-scatter (each
    rank sums its chunk of every rank's ``x``) and an all-gather of the
    sums: the same sums as one all-gather and a sum of every copy, with
    ``ax.size`` times fewer bytes held and summed a rank. Over two, the
    one all-gather moves and holds no more, in one exchange."""
    n = x.numel()
    if ax.size <= 2 or n % ax.size:
        return ordered_sum(_gather(x, ax), x.dtype)
    got = _exchange(x.reshape(ax.size, n // ax.size), ax)
    mine = ordered_sum(list(got), x.dtype)
    return torch.cat(_gather(mine, ax)).reshape(x.shape)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _sum_over(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        s = ordered_sum(_gather(x, ax), torch.float32)
        return (s / ax.size).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ax.size, None


class _Varying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.ax), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _exchange(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.ax), None


def all_gather(x: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    return x if ax.size == 1 else _AllGather.apply(x.contiguous(), ax, dim)


def all_gather_invariant(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _AllGatherInvariant.apply(x.contiguous(),
                                                            ax)


def own_slice(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _OwnSlice.apply(x, ax)


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _Psum.apply(x.contiguous(), ax)


def pmean(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _Pmean.apply(x.contiguous(), ax)


def varying(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    return x if ax.size == 1 else _Varying.apply(x, ax)


def all_to_all(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    if x.shape[0] != ax.size:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not the "
                         f"axis size {ax.size}")
    return x if ax.size == 1 else _AllToAll.apply(x.contiguous(), ax)
