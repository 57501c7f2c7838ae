"""Plain torch version of the per-row top-k by magnitude.

What the JAX package's oracle ``topk_compress_ref`` computes with
``lax.top_k``: the k largest ``|x|`` of each row, taken in float32, in
descending order with the lower index first among equal magnitudes, NaN
above every number. A stable descending sort gives exactly that order. The
CUDA kernel ``csrc/topk_compress.cu`` agrees with it bit for bit.
"""
from __future__ import annotations

import torch


def _sorted_mag(x: torch.Tensor, k: int):
    mag = x.abs().to(torch.float32)
    s = torch.sort(mag, dim=1, descending=True, stable=True)
    return s.values[:, :k], s.indices[:, :k]


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def topk_compress_torch(x: torch.Tensor, k: int):
    """x (R, D) -> (values (R, k) in x's dtype, indices (R, k) int32)."""
    _, idx = _sorted_mag(x, k)
    # gathered as raw bits: a bfloat16 gather on the CPU rewrites NaNs
    bits = _BITS.get(x.dtype, x.dtype)
    vals = torch.gather(x.view(bits), 1, idx).view(x.dtype)
    return vals, idx.to(torch.int32)


def topk_threshold_torch(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest ``|x|`` of each row of (R, D), float32 (R,)."""
    return _sorted_mag(x, k)[0][:, k - 1].contiguous()
