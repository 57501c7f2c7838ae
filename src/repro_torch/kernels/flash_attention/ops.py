"""Flash attention: shape checks and device dispatch.

A CUDA tensor always launches the kernel; a CPU tensor runs the plain
version. There is no option that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda
from .ref import flash_attention_gqa_torch, flash_attention_torch


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(BH, T, D) attention of q over k, v (BH, S, D), scale 1/sqrt(D), any
    T and S. With ``causal`` query row i sees keys 0..i."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"bad shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    d = q.shape[2]
    out = flash_attention_cuda(q[:, :, None], k[:, :, None], v[:, :, None],
                               1.0 / (d ** 0.5), causal)
    return out[:, :, 0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (B, T, H, D) over k, v (B, S, Hkv, D) -> (B, T, H, D), query head h
    on KV head h // (H / Hkv). k and v may be strided views (a cache
    prefix). ``scale`` is a float or a 0-d float32 tensor. A ``window``
    w > 0 (causal, T == S) limits row i to keys i - w < j <= i."""
    if q.device.type == "cpu":
        return flash_attention_gqa_torch(q, k, v, scale, causal, window)
    return flash_attention_cuda(q, k, v, float(scale), causal, window)
