"""Masked group sum: shape checks and device dispatch.

A CUDA tensor always launches the kernel; a CPU tensor runs the plain
version. There is no option that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from .ref import reduce_rows_torch, segment_reduce_torch
from .segment_reduce import segment_reduce_cuda


def segment_reduce(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked sum over the child axis: (G, C, D), (G, C) -> (G, D)."""
    if x.ndim != 3 or tuple(mask.shape) != tuple(x.shape[:2]):
        raise ValueError(f"bad shapes {tuple(x.shape)} {tuple(mask.shape)}")
    if x.device.type == "cpu":
        return segment_reduce_torch(x, mask)
    return segment_reduce_cuda(x.contiguous(), mask)


def reduce_rows(flat: torch.Tensor, mask: torch.Tensor, rows: torch.Tensor,
                *, inplace: bool = False) -> torch.Tensor:
    """The reduce executor's Reduce over row spans of a (R, D) buffer.

    Group g folds rows ``rows[g] .. rows[g] + C - 1`` of ``flat`` under
    ``mask[g]`` (G, C), in ascending order; returns the (G, D) sums, or
    with ``inplace=True`` writes each over row ``rows[g]`` and returns
    ``flat``. The sum is rounded to ``flat``'s dtype after every add, as
    the JAX fold's carry is (bfloat16 addition; for float32 the plain
    fold). The kernel on a CUDA buffer, the plain version on a CPU one.
    """
    if flat.device.type == "cpu":
        return reduce_rows_torch(flat, mask, rows, inplace=inplace)
    return segment_reduce_cuda(flat, mask, rows, inplace=inplace,
                               round_each=True)
