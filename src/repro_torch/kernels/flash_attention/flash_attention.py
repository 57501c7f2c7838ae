"""Launcher of the CUDA flash attention (``csrc/flash_attention.cu``).

The port's counterpart of the Pallas ``flash_attention_pallas``. Its plain
versions are in :mod:`repro_torch.kernels.flash_attention.ref`, with which
it agrees to rounding. It takes the model's layout, q (B, T, H, D) and k, v
(B, S, Hkv, D), as strided views whose last dimension is contiguous (a
decode passes the cache prefix ``k_all[:, :n]`` with no copy), and writes a
new contiguous (B, T, H, D). T = 1 takes the kernel's decode launch shape.
A sliding ``window`` w > 0 (causal self-attention, T == S) limits query
row i to keys i - w < j <= i, and the kernel skips the key tiles outside
that band. Counts each launch in ``.launches``.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .ref import check_window

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
_INT_MAX = 2 ** 31 - 1


def geometry(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             what: str = "flash_attention_cuda") -> tuple:
    """The kernel's shape and stride arguments for q (B, T, H, D) and k, v
    (B, S, Hkv, D): (B, T, S, H, Hkv, D, q strides (b, t, h), k strides,
    v strides), in elements. Raises on what the kernel does not take."""
    if q.dtype not in _BF16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32/bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: bad shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if min(B, T, S, H, Hkv) < 1 or H % Hkv or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: needs T, S >= 1, H a multiple of Hkv and "
                         f"0 < D <= {MAX_HEAD_DIM}, got {tuple(q.shape)} "
                         f"{tuple(k.shape)}")
    if B * H * -(-T // 64) > _INT_MAX or max(T, S) > _INT_MAX:
        raise ValueError(f"{what}: too many blocks for {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{what}: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    return (B, T, S, H, Hkv, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3])


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool,
                         window: int = 0) -> torch.Tensor:
    """Attention of q (B, T, H, D) over k, v (B, S, Hkv, D) on the card ->
    (B, T, H, D) in q's dtype, within a sliding ``window`` when it is
    positive. Counts each launch in ``.launches``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda needs q, k, v on one "
                             f"CUDA device, got {name} on {t.device}")
    g = geometry(q, k, v)
    check_window(q.shape[1], k.shape[1], causal, window,
                 "flash_attention_cuda")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = library().soar_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _BF16[q.dtype], *g, *out.stride()[:3], int(causal), int(window),
            float(scale), stream_of(q))
    check(err, "flash attention launch")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
