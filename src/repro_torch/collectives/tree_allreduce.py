"""Single-card executor of the SOAR reduction program.

Runs the paper's Reduce (Algorithm 1) over all devices' inputs held on one
device: red switches forward message slots upward (``PermuteRound``), blue
switches collapse their slots into one partial sum (``CompressOp``), a
degraded switch's spilled overflow is completed one hop up (``FoldOp``,
``CompactOp``), and the destination folds what reaches the root. The result
is the ``(D,)`` sum that the JAX package's shard_map executor returns on
every device.

The JAX package's ``_apply_program`` keeps an ``(n_slots, D)`` buffer per
device and moves rows through it. Here the program is run once, when it is
compiled, over what each ``(device, slot)`` *holds*: nothing (``EMPTY``),
device v's input row ``X(v)``, or partial ``P(j)``. Only the folds remain,
each a Reduce whose gather table names the rows it folds (a row of ``x`` or
of a scratch of partials, -1 for nothing) and the partial it writes. A call
allocates the ``(n_partials, D)`` scratch uninitialised (every partial is
written before it is read) and launches one segment-reduce kernel per
Reduce, in program order, and nothing else; on CPU tensors each Reduce runs
the kernel's plain version over the same tables.

Slot contents, op by op (slot 0 of every device starts as ``X(v)``, the
others ``EMPTY``): a ``PermuteRound`` reads every delivery from the state
before the round, a delivered slot takes the sender's content and the
sender keeps its own; a delivery onto a slot that is not ``EMPTY`` becomes
a two-row Reduce (old content, then the delivered one), which
``build_program``'s programs never need. A ``CompressOp`` folds slots
``[0, width)`` into a new partial at slot 0 and empties ``[1, width)``; a
``FoldOp`` folds ``[start, start + count)`` into a new partial at ``start``;
a ``CompactOp`` gathers contents (-1: ``EMPTY``); the destination folds
``root_home``'s ``[0, max(root_count, 1))``.

Bits: the JAX buffer adds what it receives (``0 + x``) and folds every
slot of a span, empty ones as +0. The tables leave out what is ``EMPTY``,
and that changes no bit: a fold starts at +0, under round-to-nearest a sum
is -0 only if both operands are -0, so the accumulator is never -0, and
adding +0 to it is the identity; for the same reason a row that holds -0
where the JAX buffer holds ``0 + (-0) = +0`` folds alike. Folds start at
+0, where the JAX fold starts at its first slot: the two differ only in
the sign of a zero sum. The partials keep ``x``'s dtype, float32 or
bfloat16, as the JAX buffer does; a bfloat16 fold rounds after every add,
because the JAX fold carries a bfloat16 accumulator through its
``fori_loop`` (held bitwise against the JAX executor in
``tests/test_torch_executor.py``).

A program's tables are built once per program and device and kept while
the program lives.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..kernels.segment_reduce.ops import reduce_table
from .schedule import CompactOp, CompressOp, FoldOp, PermuteRound, ReduceProgram

EMPTY = -1


@dataclasses.dataclass(frozen=True)
class _Reduce:
    table: torch.Tensor        # (G, C) int64: row of x (< n_dev), or
                               # n_dev + partial; -1 reads nothing
    out_rows: torch.Tensor     # (G,) int64: the partial each group writes


@dataclasses.dataclass(frozen=True)
class DeviceProgram:
    """A :class:`ReduceProgram` compiled to Reduce tables on one device."""

    n_dev: int
    n_partials: int            # rows of the scratch of partials
    steps: tuple               # _Reduce, in program order
    dest: _Reduce | None       # writes the result; None: no device homes
                               # the root
    merges: int                # deliveries onto an occupied slot, each a
                               # group of a two-row Reduce

    @property
    def n_reduce(self) -> int:
        """Reduce launches per call: one per step, one at the root."""
        return len(self.steps) + (self.dest is not None)


def compile_program(prog: ReduceProgram, device) -> DeviceProgram:
    """Validate ``prog`` and compile it to Reduce tables on ``device``."""
    device = torch.device(device)
    n_dev, S = prog.n_dev, prog.n_slots
    # what each slot holds: v < n_dev is X(v), n_dev + j is P(j)
    slots = np.full((n_dev, S), EMPTY, np.int64)
    slots[:, 0] = np.arange(n_dev)
    steps: list[_Reduce] = []
    n_partials = merges = 0

    def tables(table, out) -> _Reduce:
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                      dtype=torch.int64, device=device)
        return _Reduce(table=t(table), out_rows=t(out))

    def reduce(groups: list[list[int]]) -> list[int]:
        """A Reduce step with one group per list of row ids (``EMPTY``
        ones left out); returns the row id of each group's partial."""
        nonlocal n_partials
        rows = [[r for r in g if r != EMPTY] for g in groups]
        table = np.full((len(rows), max([1, *map(len, rows)])), EMPTY)
        for i, r in enumerate(rows):
            table[i, :len(r)] = r
        out = np.arange(n_partials, n_partials + len(rows))
        n_partials += len(rows)
        steps.append(tables(table, out))
        return (n_dev + out).tolist()

    for op in prog.ops:
        if isinstance(op, PermuteRound):
            dsts = [d for _, d in op.perm]
            if len(set(dsts)) != len(dsts):
                raise ValueError("a PermuteRound delivers twice to one "
                                 "device; the executor adds each slot once")
            old = slots.copy()
            onto = []                   # (device, slot, held, delivered)
            for s, d in op.perm:
                off, cnt = int(op.recv_offset[d]), int(op.recv_count[d])
                if not (0 <= off and off + cnt <= S and cnt <= op.slab):
                    raise ValueError(f"PermuteRound {s}->{d} writes slots "
                                     f"[{off}, {off + cnt}) of {S}")
                for j in range(cnt):
                    sent, held = old[s, j], old[d, off + j]
                    if sent == EMPTY:
                        continue        # the JAX buffer adds +0
                    if held == EMPTY:
                        slots[d, off + j] = sent
                    else:
                        onto.append((d, off + j, held, sent))
            if onto:
                merges += len(onto)
                parts = reduce([[held, sent] for *_, held, sent in onto])
                for (d, j, *_), r in zip(onto, parts):
                    slots[d, j] = r
        elif isinstance(op, CompressOp):
            dev = np.nonzero(np.asarray(op.flag, bool))[0]
            width = np.asarray(op.width, np.int64)[dev]
            if np.any(width < 1) or np.any(width > S):
                raise ValueError(f"CompressOp widths outside [1, {S}]")
            if len(dev):
                parts = reduce([slots[v, :w].tolist()
                                for v, w in zip(dev, width)])
                for v, w, r in zip(dev, width, parts):
                    slots[v, 1:w] = EMPTY
                    slots[v, 0] = r
        elif isinstance(op, FoldOp):
            count = np.asarray(op.count, np.int64)
            dev = np.nonzero(count > 0)[0]
            start = np.asarray(op.start, np.int64)[dev]
            if np.any(start < 0) or np.any(start + count[dev] > S):
                raise ValueError(f"FoldOp spans outside [0, {S})")
            if len(dev):
                parts = reduce([slots[v, a:a + count[v]].tolist()
                                for v, a in zip(dev, start)])
                for v, a, r in zip(dev, start, parts):
                    slots[v, a] = r
        elif isinstance(op, CompactOp):
            src = np.asarray(op.src, np.int64)
            if src.shape != (n_dev, S) or np.any(src >= S):
                raise ValueError(f"CompactOp map must be ({n_dev}, {S}) "
                                 f"slot ids or -1")
            gathered = np.take_along_axis(slots, np.maximum(src, 0), axis=1)
            slots = np.where(src >= 0, gathered, EMPTY)
        else:
            raise TypeError(f"unknown program op {type(op).__name__}")
    dest = None
    if prog.root_home >= 0:
        # the JAX fold reads slot 0 even when nothing reaches the root
        width = max(int(prog.root_count), 1)
        if width > S:
            raise ValueError(f"root_count {prog.root_count} > n_slots {S}")
        rows = [r for r in slots[prog.root_home, :width] if r != EMPTY]
        dest = tables([rows or [EMPTY]], [0])
    return DeviceProgram(n_dev=n_dev, n_partials=n_partials,
                         steps=tuple(steps), dest=dest, merges=merges)


_PROGRAM_CACHE: dict[tuple, tuple] = {}


def device_program(prog: ReduceProgram, device) -> DeviceProgram:
    """:func:`compile_program`, cached per (program identity, device) and
    dropped when the program is collected. Programs are treated as
    immutable: build a new one rather than editing one that has run."""
    key = (id(prog), str(torch.device(device)))
    hit = _PROGRAM_CACHE.get(key)
    if hit is not None and hit[0]() is prog:
        return hit[1]
    dp = compile_program(prog, device)
    _PROGRAM_CACHE[key] = (
        weakref.ref(prog, lambda _, k=key: _PROGRAM_CACHE.pop(k, None)), dp)
    return dp


def tree_allreduce(x: torch.Tensor, prog: ReduceProgram) -> torch.Tensor:
    """AllReduce-sum of ``x`` (n_dev, D) following the SOAR program.

    Returns the (D,) sum on ``x``'s device in ``x``'s dtype (float32 or
    bfloat16): one segment-reduce launch per Reduce of the compiled program
    on a CUDA tensor, its plain version on a CPU tensor.
    """
    if x.ndim != 2 or x.shape[0] != prog.n_dev:
        raise ValueError(f"x must be ({prog.n_dev}, D), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the executor runs float32 or bfloat16, got "
                        f"{x.dtype}")
    dp = device_program(prog, x.device)
    x = x.contiguous()
    d = x.shape[1]
    scratch = x.new_empty((dp.n_partials, d))
    for st in dp.steps:
        reduce_table(x, st.table, scratch=scratch, out=scratch,
                     out_rows=st.out_rows)
    if dp.dest is None:
        return x.new_zeros(d)
    out = x.new_empty(d)
    reduce_table(x, dp.dest.table, scratch=scratch, out=out.view(1, d))
    return out


def tree_allreduce_tree(grads, prog: ReduceProgram):
    """:func:`tree_allreduce` of every tensor in a dict, list or tuple
    (nested), each with leading dim ``n_dev``; a tensor of shape
    ``(n_dev, *s)`` reduces to shape ``s``."""
    if isinstance(grads, dict):
        return {k: tree_allreduce_tree(v, prog) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(tree_allreduce_tree(v, prog) for v in grads)
    g = grads
    if g.ndim == 0 or g.shape[0] != prog.n_dev:
        raise ValueError(f"leading dim must be n_dev={prog.n_dev}, got "
                         f"{tuple(g.shape)}")
    return tree_allreduce(g.reshape(prog.n_dev, -1), prog).reshape(
        g.shape[1:])
