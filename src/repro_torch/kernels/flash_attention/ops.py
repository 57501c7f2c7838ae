"""Flash attention: shape checks and device dispatch.

A CUDA tensor always launches the kernel; a CPU tensor runs the plain
version (a counter counts it as the kernel: ``kernels.plain``). There is
no option that sends a CUDA tensor to the plain version.
Values may be narrower than keys (MLA's prefill: keys 96 wide, values
64), and ``flash_mla_decode`` is MLA's absorbed decode over the latent
cache.
"""
from __future__ import annotations

import torch

from ..plain import kernel_call
from .flash_attention import (DECODE_HEADS, decode_splits,
                              flash_attention_cuda, flash_mla_decode_cuda,
                              geometry, mla_shapes, mla_splits)
from .ref import (flash_attention_gqa_torch, flash_attention_torch,
                  flash_decode_split_torch, flash_mla_decode_torch)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """(BH, T, D) attention of q over k, v (BH, S, D), scale 1/sqrt(D), any
    T and S. With ``causal`` query row i sees keys 0..i."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"bad shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        with kernel_call("flash_attention", q, k, v) as done:
            return done(flash_attention_torch(q, k, v, causal))
    d = q.shape[2]
    out = flash_attention_cuda(q[:, :, None], k[:, :, None], v[:, :, None],
                               1.0 / (d ** 0.5), causal)
    return out[:, :, 0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (B, T, H, D) over k (B, S, Hkv, D) and v (B, S, Hkv, Dv), Dv <= D
    -> (B, T, H, Dv), query head h on KV head h // (H / Hkv). k and v may
    be strided views (a cache prefix). ``scale`` is a float or a 0-d
    float32 tensor. A ``window`` w > 0 (causal, T == S) limits row i to
    keys i - w < j <= i."""
    if q.device.type == "cpu":
        with kernel_call("flash_attention", q, k, v) as done:
            return done(flash_attention_gqa_torch(q, k, v, scale, causal,
                                                  window))
    return flash_attention_cuda(q, k, v, float(scale), causal, window)


def flash_decode_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale) -> tuple[torch.Tensor, torch.Tensor]:
    """The split decode with its merge's log-sum-exp: q (B, 1, H, D) over
    k (B, n, Hkv, D), v (B, n, Hkv, Dv) -> (out (B, 1, H, Dv), lse (B, H)
    float32), lse the log of each head's softmax denominator over the n
    keys, what merging ``out`` with another block's needs. On a CPU
    tensor the plain twin ``flash_decode_split_torch`` with the kernel's
    splits."""
    if q.device.type == "cpu":
        B, _, n, H, Hkv = geometry(q, k, v)[:5]
        n_split = decode_splits(n, B * Hkv * -(-(H // Hkv) // DECODE_HEADS))
        with kernel_call("flash_attention", q, k, v) as done:
            out, lse = flash_decode_split_torch(q, k, v, scale, n_split,
                                                lse=True)
            return done(out), lse
    return flash_attention_cuda(q, k, v, float(scale), False, lse=True)


def flash_mla_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv: torch.Tensor, kr: torch.Tensor,
                     scale) -> torch.Tensor:
    """MLA's absorbed decode: q_lat (B, 1, H, r) and q_rope (B, 1, H, rd)
    over the latent cache prefix ckv (B, n, r), kr (B, n, rd) -> ctx_lat
    (B, 1, H, r), the softmax of (q_lat . ckv + q_rope . kr) * scale
    times ckv. ``scale`` is a float or a 0-d float32 tensor. On CPU
    tensors any widths; on the card the kernels' (``mla_geometry``)."""
    if q_lat.device.type == "cpu":
        B, n, H, r, _ = mla_shapes(q_lat, q_rope, ckv, kr)
        with kernel_call("flash_mla_decode", q_lat, q_rope, ckv,
                         kr) as done:
            return done(flash_mla_decode_torch(q_lat, q_rope, ckv, kr, scale,
                                               mla_splits(B, H, n, r)))
    return flash_mla_decode_cuda(q_lat, q_rope, ckv, kr, float(scale))
