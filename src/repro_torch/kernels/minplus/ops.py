"""Batched min-plus convolution: shape checks and device dispatch."""
from __future__ import annotations

import torch

from .levelfold import minplus_fused
from .minplus import minplus_cuda


def minplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical convolution, (rows, K) x (rows, K) -> (rows, K).

    On a CUDA tensor this launches the min-plus kernel, on a CPU tensor it
    runs the plain :func:`minplus_fused`; both keep the candidate set of
    the JAX package's Pallas kernel and agree bit for bit.
    """
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return minplus_fused(a, b)
    return minplus_cuda(a.contiguous(), b.contiguous())
