"""Single-card executor of the SOAR reduction program.

Runs the paper's Reduce (Algorithm 1) over all devices' buffers held on one
device: red switches forward message slots upward (``PermuteRound``), blue
switches collapse their slots into one partial sum (``CompressOp``), a
degraded switch's spilled overflow is completed one hop up (``FoldOp``,
``CompactOp``), and the destination folds what reaches the root. The result
is the ``(D,)`` sum that the JAX package's shard_map executor returns on
every device.

The arithmetic is the JAX package's ``_apply_program``: a buffer of
``(n_dev, n_slots, D)`` zeros with slot 0 set to ``x``; received slots are
*added* (``0 + x``); every fold is a strict left fold in slot order. Each
Reduce (one per ``CompressOp`` or ``FoldOp``, plus the destination's) is one
launch of the segment-reduce kernel on a CUDA buffer, and its plain torch
version on a CPU buffer. Folds start at +0, where the JAX fold starts at its
first slot and adds +0 past the fold's width: the two differ only in the
sign of a zero sum. The buffer keeps ``x``'s dtype, float32 or bfloat16,
as the JAX buffer does; a bfloat16 fold rounds after every add, because
the JAX fold carries a bfloat16 accumulator through its ``fori_loop``
(held bitwise against the JAX executor in ``tests/test_torch_executor.py``).

The buffer is updated in place. A program's index and mask tensors are
built once per program and device and kept while the program lives.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..kernels.segment_reduce.ops import reduce_rows
from .schedule import CompactOp, CompressOp, FoldOp, PermuteRound, ReduceProgram


@dataclasses.dataclass(frozen=True)
class _Permute:
    src: torch.Tensor          # flat slot rows sent, gathered first
    dst: torch.Tensor          # flat slot rows they are added to (unique)


@dataclasses.dataclass(frozen=True)
class _Reduce:
    rows: torch.Tensor         # (G,) flat row of each span's first slot
    mask: torch.Tensor         # (G, C) float32: 1 inside the span
    clear: torch.Tensor | None  # flat rows set to 0 after the fold


@dataclasses.dataclass(frozen=True)
class _Compact:
    src: torch.Tensor          # flat rows gathered first
    dst: torch.Tensor          # flat rows they are copied to
    zero: torch.Tensor         # flat rows set to 0


@dataclasses.dataclass(frozen=True)
class DeviceProgram:
    """A :class:`ReduceProgram`'s steps as index and mask tensors on one
    device (slot ``s`` of device ``v`` is row ``v * n_slots + s`` of the
    flattened buffer)."""

    n_dev: int
    n_slots: int
    steps: tuple               # _Permute | _Reduce | _Compact, in order
    dest: _Reduce | None       # None: no device homes the root

    @property
    def n_reduce(self) -> int:
        """Reduce launches per call: one per fold step, one at the root."""
        return (sum(isinstance(s, _Reduce) for s in self.steps)
                + (self.dest is not None))


def _spans(dev: np.ndarray, start: np.ndarray, count: np.ndarray,
           n_slots: int, device: torch.device) -> _Reduce:
    """A Reduce over span ``[start, start + count)`` of each device."""
    c_max = int(count.max())
    mask = np.arange(c_max)[None, :] < count[:, None]
    return _Reduce(
        rows=torch.as_tensor(dev * n_slots + start, dtype=torch.int64,
                             device=device),
        mask=torch.as_tensor(mask, dtype=torch.float32, device=device),
        clear=None)


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64).reshape(-1),
                           dtype=torch.int64, device=device)


def compile_program(prog: ReduceProgram, device) -> DeviceProgram:
    """Validate ``prog`` and lay its ops out as tensors on ``device``."""
    device = torch.device(device)
    n_dev, S = prog.n_dev, prog.n_slots
    steps = []
    for op in prog.ops:
        if isinstance(op, PermuteRound):
            dsts = [d for _, d in op.perm]
            if len(set(dsts)) != len(dsts):
                raise ValueError("a PermuteRound delivers twice to one "
                                 "device; the executor adds each slot once")
            src, dst = [], []
            for s, d in op.perm:
                off, cnt = int(op.recv_offset[d]), int(op.recv_count[d])
                if not (0 <= off and off + cnt <= S and cnt <= op.slab):
                    raise ValueError(f"PermuteRound {s}->{d} writes slots "
                                     f"[{off}, {off + cnt}) of {S}")
                src.extend(s * S + j for j in range(cnt))
                dst.extend(d * S + off + j for j in range(cnt))
            steps.append(_Permute(_idx(src, device), _idx(dst, device)))
        elif isinstance(op, CompressOp):
            dev = np.nonzero(np.asarray(op.flag, bool))[0]
            width = np.asarray(op.width, np.int64)[dev]
            if np.any(width < 1) or np.any(width > S):
                raise ValueError(f"CompressOp widths outside [1, {S}]")
            red = _spans(dev, np.zeros_like(dev), width, S, device)
            clear = [v * S + j for v, w in zip(dev, width)
                     for j in range(1, int(w))]
            steps.append(dataclasses.replace(
                red, clear=_idx(clear, device) if clear else None))
        elif isinstance(op, FoldOp):
            count = np.asarray(op.count, np.int64)
            dev = np.nonzero(count > 0)[0]
            start = np.asarray(op.start, np.int64)[dev]
            if np.any(start < 0) or np.any(start + count[dev] > S):
                raise ValueError(f"FoldOp spans outside [0, {S})")
            steps.append(_spans(dev, start, count[dev], S, device))
        elif isinstance(op, CompactOp):
            src = np.asarray(op.src, np.int64)
            if src.shape != (n_dev, S) or np.any(src >= S):
                raise ValueError(f"CompactOp map must be ({n_dev}, {S}) "
                                 f"slot ids or -1")
            base = (np.arange(n_dev) * S)[:, None]
            moved = src != np.arange(S)[None, :]
            keep = moved & (src >= 0)
            steps.append(_Compact(
                src=_idx((base + src)[keep], device),
                dst=_idx((base + np.arange(S)[None, :])[keep], device),
                zero=_idx((base + np.arange(S)[None, :])[moved & (src < 0)],
                          device)))
        else:
            raise TypeError(f"unknown program op {type(op).__name__}")
    dest = None
    if prog.root_home >= 0:
        # the JAX fold reads slot 0 even when nothing reaches the root
        width = max(int(prog.root_count), 1)
        if width > S:
            raise ValueError(f"root_count {prog.root_count} > n_slots {S}")
        dest = _spans(np.asarray([prog.root_home]), np.zeros(1, np.int64),
                      np.asarray([width]), S, device)
    return DeviceProgram(n_dev=n_dev, n_slots=S, steps=tuple(steps),
                         dest=dest)


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
    bfloat16), through the segment-reduce kernel on a CUDA tensor and its
    plain version on a CPU tensor.
    """
    if x.ndim != 2 or x.shape[0] != prog.n_dev:
        raise ValueError(f"x must be ({prog.n_dev}, D), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the executor runs float32 or bfloat16, got "
                        f"{x.dtype}")
    dp = device_program(prog, x.device)
    n_dev, d = x.shape
    buf = x.new_zeros((n_dev, dp.n_slots, d))
    buf[:, 0] = x
    flat = buf.view(n_dev * dp.n_slots, d)
    for st in dp.steps:
        if isinstance(st, _Permute):
            flat.index_add_(0, st.dst, flat.index_select(0, st.src))
        elif isinstance(st, _Reduce):
            reduce_rows(flat, st.mask, st.rows, inplace=True)
            if st.clear is not None:
                flat.index_fill_(0, st.clear, 0.0)
        else:
            moved = flat.index_select(0, st.src)
            flat.index_fill_(0, st.zero, 0.0)
            flat.index_copy_(0, st.dst, moved)
    if dp.dest is None:
        return x.new_zeros(d)
    return reduce_rows(flat, dp.dest.mask, dp.dest.rows)[0]


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
