"""Gather-table segment reduce: shape checks and device dispatch.

A CUDA tensor always launches the kernel; a CPU tensor runs the plain
version. There is no option that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from .ref import segment_reduce_torch
from .segment_reduce import segment_reduce_cuda


def segment_reduce(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked sum over the child axis: (G, C, D), (G, C) -> (G, D)."""
    if x.ndim != 3 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"bad shapes {tuple(x.shape)} {tuple(mask.shape)}")
    if x.device.type == "cpu":
        return segment_reduce_torch(x, mask)
    return segment_reduce_cuda(x.contiguous(), mask)


def reduce_table(x: torch.Tensor, table: torch.Tensor, *,
                 scratch: torch.Tensor | None = None,
                 out: torch.Tensor | None = None,
                 out_rows: torch.Tensor | None = None) -> torch.Tensor:
    """The reduce executor's Reduce: group g folds, in ascending c, the rows
    that ``table[g]`` names (``i < R0``: row i of the (R0, D) ``x``;
    ``i >= R0``: row ``i - R0`` of ``scratch``; -1: nothing) and writes the
    sum over row ``out_rows[g]`` of ``out`` (a new (G, D) when ``out`` is
    None). The sum is rounded to ``x``'s dtype after every add, as the JAX
    fold's carry is (bfloat16 addition; for float32 the plain fold). The
    kernel on CUDA tensors, the plain version on CPU ones.
    """
    if x.device.type == "cpu":
        return segment_reduce_torch(x, None, table, scratch=scratch, out=out,
                                    out_rows=out_rows, round_each=True)
    return segment_reduce_cuda(x, None, table, scratch=scratch, out=out,
                               out_rows=out_rows, round_each=True)
