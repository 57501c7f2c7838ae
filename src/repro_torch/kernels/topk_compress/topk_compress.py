"""Launchers of the CUDA top-k (``csrc/topk_compress.cu``).

The port's counterpart of the Pallas ``topk_compress_pallas``. Its plain
version is :mod:`repro_torch.kernels.topk_compress.ref` (a stable
descending sort), with which it agrees bit for bit. ``topk_threshold_cuda``
runs the kernel's select stage alone: the threshold is all that gradient
compression needs. Both count their launches in ``.launches``.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of

_TILE = 2048                     # elements per tile of the kernel
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _checked(x: torch.Tensor, k: int, what: str) -> tuple[int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in _BF16:
        raise TypeError(f"{what} takes float32/bfloat16, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{what} needs a contiguous (R, D) tensor, got "
                         f"{tuple(x.shape)}")
    r, d = x.shape
    if not 0 < k <= d:
        raise ValueError(f"bad k={k} for rows of {d}")
    if d >= 2 ** 31 or r > 65535:
        raise ValueError(f"{what}: rows of {d} (< 2^31) and {r} rows "
                         f"(<= 65535) only")
    return r, d


def _select_scratch(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The select stage's per-row state (prefix, k - n_gt, n_gt, n_eq) and
    histogram."""
    r = x.shape[0]
    state = torch.empty((r, 4), dtype=torch.int32, device=x.device)
    hist = torch.empty((r, 256), dtype=torch.int32, device=x.device)
    return state, hist


def topk_threshold_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest ``|x|`` of each row of (R, D) -> float32 (R,), by the
    kernel's radix select. Counts each launch in ``.launches``."""
    r, d = _checked(x, k, "topk_threshold_cuda")
    state, hist = _select_scratch(x)
    with torch.cuda.device(x.device):
        err = library().soar_topk_select(
            x.data_ptr(), _BF16[x.dtype], r, d, k, state.data_ptr(),
            hist.data_ptr(), stream_of(x))
    check(err, "top-k select launch")
    topk_threshold_cuda.launches += 1
    return state[:, 0].view(torch.float32)


def topk_compress_cuda(x: torch.Tensor, k: int):
    """x (R, D) -> (values (R, k) in x's dtype, indices (R, k) int32) by
    descending ``|x|``, the lower index first on ties. Counts each launch in
    ``.launches``."""
    r, d = _checked(x, k, "topk_compress_cuda")
    dev = x.device
    state, hist = _select_scratch(x)
    n_tiles = -(-d // _TILE)
    k_tiles = -(-k // _TILE)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    tile_a, tile_b = scratch(r, n_tiles), scratch(r, n_tiles)
    key_a, key_b, idx_a, idx_b = (scratch(r, k) for _ in range(4))
    counts = scratch(r, 256 * k_tiles)
    values = torch.empty((r, k), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = library().soar_topk_compress(
            x.data_ptr(), _BF16[x.dtype], r, d, k, state.data_ptr(),
            hist.data_ptr(), tile_a.data_ptr(), tile_b.data_ptr(),
            key_a.data_ptr(), key_b.data_ptr(), idx_a.data_ptr(),
            idx_b.data_ptr(), counts.data_ptr(), values.data_ptr(),
            stream_of(x))
    check(err, "top-k kernel launch")
    topk_compress_cuda.launches += 1
    return values, idx_a


topk_threshold_cuda.launches = 0
topk_compress_cuda.launches = 0
