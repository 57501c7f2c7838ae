"""Executors of the SOAR reduction program: on one card
(:func:`tree_allreduce`) and one rank per device over ``torch.distributed``
(:func:`reduce_local`, below its own heading).

Both run the paper's Reduce (Algorithm 1): red switches forward message
slots upward (``PermuteRound``), blue switches collapse their slots into
one partial sum (``CompressOp``), a degraded switch's spilled overflow is
completed one hop up (``FoldOp``, ``CompactOp``), and the destination folds
what reaches the root. The single-card executor takes all devices' inputs
held on one device and returns the ``(D,)`` sum that the JAX package's
shard_map executor returns on every device.

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

A program's tables are built once per program and device (and rank) and
kept while the program lives.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref

import numpy as np
import torch
import torch.distributed as dist

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


@dataclasses.dataclass(frozen=True)
class _Round:
    """One ``PermuteRound`` as one rank takes part in it: one message a
    peer it sends to or receives from, each the rows that carry content."""
    sends: tuple               # (peer, rows (n,) int64 of the store, alone):
                               # alone, the message is the input row only
    recvs: tuple               # (peer, first store row, rows): received
                               # into contiguous rows of the store


@dataclasses.dataclass(frozen=True)
class RankProgram:
    """A :class:`ReduceProgram` compiled for one rank (device index) of a
    process group: its rounds' messages and its own Reduces.

    The rank keeps a row store of ``n_rows + n_partials`` rows: row 0 its
    input, rows ``[1, n_rows)`` the rows it receives, in the order they
    arrive, then its partials. A Reduce's table reads the store (entries
    ``< n_rows``: a row; ``n_rows + j``: partial j; -1: nothing) and
    writes partials, as :class:`DeviceProgram`'s tables read ``x`` and the
    scratch.
    """

    n_dev: int
    rank: int
    n_rows: int                # input row + received rows
    n_partials: int
    steps: tuple               # _Round and _Reduce, in program order
    dest: _Reduce | None       # writes the result here: this rank homes
                               # the root
    input_row: bool            # a table or a multi-row message reads row
                               # 0, so the call copies the input there

    @property
    def n_reduce(self) -> int:
        """Reduce launches per call on this rank."""
        return (sum(isinstance(st, _Reduce) for st in self.steps)
                + (self.dest is not None))

    @property
    def rows_sent(self) -> int:
        return sum(len(rows) for st in self.steps if isinstance(st, _Round)
                   for _, rows, _ in st.sends)

    @property
    def rows_received(self) -> int:
        return sum(n for st in self.steps if isinstance(st, _Round)
                   for *_, n in st.recvs)


def _trace(prog: ReduceProgram):
    """Run ``prog`` once over what each ``(device, slot)`` holds (see the
    module docstring) and validate it.

    Returns ``(events, dest, merges)``: ``events`` in program order, each
    ``("round", [(src, dst, [content, ...]), ...])``, the contents a
    ``PermuteRound`` delivers per pair in slot order (``EMPTY`` ones left
    out), or ``("reduce", [(device, [content, ...], new), ...])``, a Reduce
    step whose groups fold contents (``EMPTY`` ones left out) into the new
    partial ``new``; ``dest`` is ``(root_home, [content, ...])`` or None;
    ``merges`` counts deliveries onto an occupied slot. A content is
    ``v < n_dev`` for ``X(v)`` and ``n_dev + j`` for partial ``P(j)``.
    """
    n_dev, S = prog.n_dev, prog.n_slots
    slots = np.full((n_dev, S), EMPTY, np.int64)
    slots[:, 0] = np.arange(n_dev)
    events: list = []
    n_ids, merges = n_dev, 0

    def reduce(groups: list) -> list[int]:
        """A Reduce step with one group per ``(device, contents)``; returns
        the content id of each group's partial."""
        nonlocal n_ids
        step = []
        for dev, ids in groups:
            step.append((int(dev), [int(r) for r in ids if r != EMPTY],
                         n_ids))
            n_ids += 1
        events.append(("reduce", step))
        return [new for *_, new in step]

    for op in prog.ops:
        if isinstance(op, PermuteRound):
            dsts = [d for _, d in op.perm]
            if len(set(dsts)) != len(dsts):
                raise ValueError("a PermuteRound delivers twice to one "
                                 "device; the executor adds each slot once")
            old = slots.copy()
            onto = []                   # (device, slot, held, delivered)
            msgs = []
            for s, d in op.perm:
                off, cnt = int(op.recv_offset[d]), int(op.recv_count[d])
                if not (0 <= off and off + cnt <= S and cnt <= op.slab):
                    raise ValueError(f"PermuteRound {s}->{d} writes slots "
                                     f"[{off}, {off + cnt}) of {S}")
                sent = []
                for j in range(cnt):
                    c, held = old[s, j], old[d, off + j]
                    if c == EMPTY:
                        continue        # the JAX buffer adds +0
                    sent.append(int(c))
                    if held == EMPTY:
                        slots[d, off + j] = c
                    else:
                        onto.append((d, off + j, held, c))
                msgs.append((int(s), int(d), sent))
            events.append(("round", msgs))
            if onto:
                merges += len(onto)
                parts = reduce([(d, [held, c]) for d, _, held, c in onto])
                for (d, j, *_), r in zip(onto, parts):
                    slots[d, j] = r
        elif isinstance(op, CompressOp):
            dev = np.nonzero(np.asarray(op.flag, bool))[0]
            width = np.asarray(op.width, np.int64)[dev]
            if np.any(width < 1) or np.any(width > S):
                raise ValueError(f"CompressOp widths outside [1, {S}]")
            if len(dev):
                parts = reduce([(v, slots[v, :w].tolist())
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
                parts = reduce([(v, slots[v, a:a + count[v]].tolist())
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
        dest = (int(prog.root_home),
                [int(r) for r in slots[prog.root_home, :width]
                 if r != EMPTY])
    return events, dest, merges


def _tables(groups: list[list[int]], out: list[int], device) -> _Reduce:
    """A Reduce's gather table (one row per group, -1 padded; a group that
    reads nothing reads -1 once) and its out rows, on ``device``."""
    table = np.full((len(groups), max([1, *map(len, groups)])), EMPTY)
    for i, r in enumerate(groups):
        table[i, :len(r)] = r
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                  dtype=torch.int64, device=device)
    return _Reduce(table=t(table), out_rows=t(out))


def compile_program(prog: ReduceProgram, device) -> DeviceProgram:
    """Validate ``prog`` and compile it to Reduce tables on ``device``."""
    device = torch.device(device)
    n_dev = prog.n_dev
    events, dest, merges = _trace(prog)
    # a content is already its row id: X(v) is row v of x, P(j) is
    # n_dev + j, row j of the scratch
    steps = tuple(_tables([ids for _, ids, _ in ev],
                          [new - n_dev for *_, new in ev], device)
                  for kind, ev in events if kind == "reduce")
    return DeviceProgram(
        n_dev=n_dev, n_partials=sum(len(st.out_rows) for st in steps),
        steps=steps,
        dest=None if dest is None else _tables([dest[1] or [EMPTY]], [0],
                                               device),
        merges=merges)


def compile_rank_program(prog: ReduceProgram, rank: int,
                         device) -> RankProgram:
    """Validate ``prog`` and compile what device ``rank`` of it does: the
    rows it sends in each ``PermuteRound`` and to whom, the rows it
    receives and from whom, and its own Reduces as gather tables over its
    row store, on ``device``.

    Only rows that carry content travel: an ``EMPTY`` slot is not sent
    (both ends know the layout from the program), where the JAX executor's
    ``ppermute`` sends the whole slab. A sender's rows for one peer in one
    round form one message. A pair that sends to itself is refused.
    """
    device = torch.device(device)
    if not 0 <= rank < prog.n_dev:
        raise ValueError(f"rank {rank} outside the program's {prog.n_dev} "
                         f"devices")
    events, dest, _ = _trace(prog)
    PART = 1 << 40                      # provisional ids of partials
    local = {rank: 0}                   # content -> store row
    n_rows, n_parts = 1, 0
    raw: list = []                      # steps with provisional ids
    for kind, ev in events:
        if kind == "round":
            if any(s == d for s, d, _ in ev):
                raise ValueError("a PermuteRound sends from a device to "
                                 "itself; the rank executor sends to peers")
            sends = [(d, [local[c] for c in sent]) for s, d, sent in ev
                     if s == rank and sent]
            recvs = []
            for s, d, sent in ev:
                if d == rank and sent:
                    recvs.append((s, n_rows, len(sent)))
                    for c in sent:
                        local[c] = n_rows
                        n_rows += 1
            if sends or recvs:
                raw.append(("round", sends, recvs))
        else:
            mine = [(ids, new) for dev, ids, new in ev if dev == rank]
            if mine:
                groups = [[local[c] for c in ids] for ids, _ in mine]
                out = list(range(n_parts, n_parts + len(mine)))
                for (_, new), j in zip(mine, out):
                    local[new] = PART + j
                n_parts += len(mine)
                raw.append(("reduce", groups, out))
    if dest is not None and dest[0] == rank:
        raw.append(("dest", [[local[c] for c in dest[1]] or [EMPTY]], [0]))
    at = lambda i: n_rows + i - PART if i >= PART else i
    steps, final, input_row = [], None, False
    for kind, a, b in raw:
        if kind == "round":
            sends = tuple(
                (peer, torch.as_tensor([at(i) for i in rows],
                                       dtype=torch.int64, device=device),
                 rows == [0]) for peer, rows in a)
            input_row |= any(0 in rows and len(rows) > 1 for _, rows in a)
            steps.append(_Round(sends=sends, recvs=tuple(b)))
        else:
            groups = [[at(i) for i in g] for g in a]
            input_row |= any(0 in g for g in groups)
            red = _tables(groups, b, device)
            if kind == "dest":
                final = red
            else:
                steps.append(red)
    return RankProgram(n_dev=prog.n_dev, rank=rank, n_rows=n_rows,
                       n_partials=n_parts, steps=tuple(steps), dest=final,
                       input_row=input_row)


_PROGRAM_CACHE: dict[tuple, tuple] = {}


def _cached(prog: ReduceProgram, key: tuple, make):
    """``make()``, cached per (program identity, ``key``) and dropped when
    the program is collected."""
    key = (id(prog),) + key
    hit = _PROGRAM_CACHE.get(key)
    if hit is not None and hit[0]() is prog:
        return hit[1]
    out = make()
    _PROGRAM_CACHE[key] = (
        weakref.ref(prog, lambda _, k=key: _PROGRAM_CACHE.pop(k, None)), out)
    return out


def device_program(prog: ReduceProgram, device) -> DeviceProgram:
    """:func:`compile_program`, cached per (program identity, device) and
    dropped when the program is collected. Programs are treated as
    immutable: build a new one rather than editing one that has run."""
    return _cached(prog, (str(torch.device(device)),),
                   lambda: compile_program(prog, device))


def rank_program(prog: ReduceProgram, rank: int, device) -> RankProgram:
    """:func:`compile_rank_program`, cached as :func:`device_program` is,
    per (program identity, rank, device)."""
    return _cached(prog, (int(rank), str(torch.device(device))),
                   lambda: compile_rank_program(prog, rank, device))


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


# -- one rank per device: torch.distributed -----------------------------------

def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in pinned host memory (the copy is complete when
    this returns)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


class Link:
    """How one process group's messages travel for tensors on ``device``.

    Under NCCL they go device to device. gloo's point-to-point reads and
    writes host memory, so under gloo every slab of a CUDA tensor is staged
    explicitly through a pinned host buffer; CPU tensors travel as they
    are. The staging is chosen by the backend's name. Peers are named by
    their rank in the group. The ``fake`` backend (a dry run's process
    group, ``launch.dryrun``) moves nothing, so nothing is staged.
    """

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "gloo":
            self.staged = self.device.type == "cuda"
        elif self.backend == "fake":
            self.staged = False
        elif self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError(f"an NCCL group sends CUDA tensors, got "
                                 f"{self.device}")
            self.staged = False
        else:
            raise ValueError(f"backend {self.backend!r}: the rank executor "
                             f"runs over gloo or nccl (or a dry run's "
                             f"fake group)")
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def peer(self, r: int) -> int:
        """The global rank of group rank ``r``."""
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def exchange(self, rnd: _Round, flat: torch.Tensor,
                 buf: torch.Tensor) -> None:
        """One round: every message packed with one gather (the input row
        alone goes as it is), all sends and receives in one
        ``batch_isend_irecv``, received rows landing in their store rows."""
        ops, land = [], []
        for peer, rows, alone in rnd.sends:
            slab = flat if alone else buf.index_select(0, rows)
            if self.staged:
                slab = _pinned(slab)
            ops.append(dist.P2POp(dist.isend, slab, self.peer(peer),
                                  self.group))
        for peer, start, count in rnd.recvs:
            dst = buf[start:start + count]
            into = (torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True)
                    if self.staged else dst)
            land.append((dst, into))
            ops.append(dist.P2POp(dist.irecv, into, self.peer(peer),
                                  self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for dst, into in land:
            if into is not dst:
                dst.copy_(into)

    def broadcast(self, t: torch.Tensor, root: int) -> None:
        """``t`` from group rank ``root`` to every rank, in place."""
        h = (_pinned(t) if self.rank == root else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True)) if self.staged else t
        dist.broadcast(h, src=self.peer(root), group=self.group)
        if h is not t:
            t.copy_(h)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t``, in rank order, on ``t``'s device."""
        src = _pinned(t) if self.staged else t.contiguous()
        outs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(outs, src, group=self.group)
        return [o.to(t.device) for o in outs]

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (size, ...): row ``i`` to group rank ``i``; returns the
        rows received, stacked in the senders' rank order, on ``t``'s
        device."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all sends one row a rank: leading dim "
                             f"{t.shape[0]}, group of {self.size}")
        src = _pinned(t) if self.staged else t.contiguous()
        out = (torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
               if self.staged else torch.empty_like(src))
        dist.all_to_all_single(out, src, group=self.group)
        return out.to(t.device)

    def gather(self, t: torch.Tensor, dst: int = 0) -> torch.Tensor | None:
        """Every rank's ``t`` stacked ``(size, ...)`` in rank order on
        group rank ``dst`` (in host memory when staged), None elsewhere."""
        src = _pinned(t) if self.staged else t.contiguous()
        outs = ([torch.empty_like(src) for _ in range(self.size)]
                if self.rank == dst else None)
        dist.gather(src, outs, dst=self.peer(dst), group=self.group)
        return None if outs is None else torch.stack(outs)


def program_fingerprint(prog: ReduceProgram) -> int:
    """A 63-bit hash of everything in ``prog``: ranks that hold programs
    with equal fingerprints run the same program."""
    h = hashlib.sha256()

    def put(a) -> None:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())

    put(np.asarray([prog.n_dev, prog.n_slots, prog.root_home,
                    prog.root_count, prog.total_network_messages]))
    put(np.float64(prog.utilization))
    for op in prog.ops:
        h.update(type(op).__name__.encode())
        for f in dataclasses.fields(op):
            put(np.asarray(getattr(op, f.name)))
    return int.from_bytes(h.digest()[:8], "little") >> 1


def check_same_program(prog: ReduceProgram, group=None, device="cpu") -> None:
    """Raise unless every rank of ``group`` holds a program with ``prog``'s
    fingerprint (a collective: every rank calls it)."""
    link = Link(group, device)
    mine = torch.tensor([program_fingerprint(prog)], dtype=torch.int64,
                        device=link.device)
    got = [int(t) for t in link.all_gather(mine)]
    if len(set(got)) != 1:
        raise RuntimeError(f"the ranks hold different reduce programs "
                           f"(fingerprints by rank: {got})")


def reduce_local(x: torch.Tensor, prog: ReduceProgram,
                 group=None) -> torch.Tensor:
    """SOAR-reduce this rank's ``x`` with the other ranks' of ``group``
    (default: the world): the global sum, on every rank, in ``x``'s dtype
    (float32 or bfloat16) and shape. The caller's rank in ``group`` is its
    device index in ``prog``; every rank of the group calls it with the
    same program and an ``x`` of the same shape (a 0-d ``x`` goes as
    ``(1, 1)``).

    The JAX package's ``reduce_local``, inside its shard_map, runs the
    program over a slot buffer per device with ``ppermute`` rounds and
    ends with a ``psum`` from the root's home. Here each rank runs its
    :class:`RankProgram`: a round is one ``batch_isend_irecv`` of the rows
    that carry content (a :class:`Link` stages them through pinned host
    memory under gloo), a Reduce one segment-reduce launch on a CUDA
    tensor and the plain version on a CPU tensor, and ``root_home`` folds
    the destination and broadcasts the result. A rank folds the same rows
    in the same order as :func:`tree_allreduce` over the stacked inputs,
    so the two agree bit for bit.

    The broadcast sends the root's bits, where ``psum`` adds the other
    devices' +0s to them. The two differ only where the root's fold is
    -0: ``psum`` then gives +0 for more than one device. The port's fold
    starts at +0 and so is never -0 (module docstring), so the broadcast
    equals the ``psum``; on one device the JAX ``psum`` is the identity and
    returns a -0 fold as it is, where the port returns +0. When no device
    homes the root, every rank returns zeros, as the ``psum`` of zeros.
    """
    n = dist.get_world_size(group)
    if n != prog.n_dev:
        raise ValueError(f"the group has {n} ranks; the program runs on "
                         f"{prog.n_dev} devices")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the executor runs float32 or bfloat16, got "
                        f"{x.dtype}")
    flat = x.reshape(1, -1).contiguous()
    d = flat.shape[1]
    link = Link(group, flat.device)
    rp = rank_program(prog, link.rank, flat.device)
    buf = flat.new_empty((rp.n_rows + rp.n_partials, d))
    rows, parts = buf[:rp.n_rows], buf[rp.n_rows:]
    if rp.input_row:
        rows[0].copy_(flat[0])
    for st in rp.steps:
        if isinstance(st, _Round):
            link.exchange(st, flat, buf)
        else:
            reduce_table(rows, st.table, scratch=parts, out=parts,
                         out_rows=st.out_rows)
    if prog.root_home < 0:
        return flat.new_zeros(x.shape)
    out = flat.new_empty((1, d))
    if rp.dest is not None:
        reduce_table(rows, rp.dest.table, scratch=parts, out=out)
    if n > 1:
        link.broadcast(out, prog.root_home)
    return out.view(x.shape)
