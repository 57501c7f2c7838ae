"""Top-k compression: shape checks and device dispatch.

A CUDA tensor always launches the kernel; a CPU tensor runs the plain
version. There is no option that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from .ref import topk_compress_torch, topk_threshold_torch
from .topk_compress import topk_compress_cuda, topk_threshold_cuda


def _valid(x: torch.Tensor, k: int) -> None:
    if x.ndim != 2 or not 0 < k <= x.shape[1]:
        raise ValueError(f"bad input {tuple(x.shape)}, k={k}")


def topk_compress(x: torch.Tensor, k: int):
    """(R, D) -> (values (R, k), indices (R, k) int32) by descending |x|."""
    _valid(x, k)
    if x.device.type == "cpu":
        return topk_compress_torch(x, k)
    return topk_compress_cuda(x.contiguous(), k)


def topk_threshold(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |x| of each row: (R, D) -> float32 (R,)."""
    _valid(x, k)
    if x.device.type == "cpu":
        return topk_threshold_torch(x, k)
    return topk_threshold_cuda(x.contiguous(), k)


def decompress(values: torch.Tensor, indices: torch.Tensor,
               d: int) -> torch.Tensor:
    """Scatter the kept entries back to dense (R, d)."""
    out = torch.zeros((values.shape[0], d), dtype=values.dtype,
                      device=values.device)
    return out.scatter_(1, indices.to(torch.int64), values)
