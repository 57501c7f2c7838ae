"""Launchers of the CUDA top-k (``csrc/topk_compress.cu``).

The port's counterpart of the Pallas ``topk_compress_pallas``. Its plain
version is :mod:`repro_torch.kernels.topk_compress.ref` (a stable
descending sort), with which it agrees bit for bit. ``topk_threshold_cuda``
runs the kernel's select stage alone: the threshold is all that gradient
compression needs. Both count their calls in ``.launches``; a select
call makes :func:`select_launches` launches on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, library, stream_of
from .ref import SMALL_ROW

_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def select_launches(dtype: torch.dtype, d: int) -> int:
    """Launches of one select call on rows of ``d`` values: one for a short
    row; else one memset of its scratch and one per 11-bit pass (three for
    float32, two for bfloat16, whose lowest 16 bits are zero)."""
    if d <= SMALL_ROW:
        return 1
    return 1 + (2 if dtype == torch.bfloat16 else 3)


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


def _scratch(x: torch.Tensor, k: int, whole: bool):
    """The call's two scratch buffers: the one the kernel zeroes first
    (the rows' states lead it) and the rest (the candidate buffer of
    D // 16 keys a row, the sort's pairs and counts)."""
    r, d = x.shape
    nbytes = (ctypes.c_longlong * 2)()
    library().soar_topk_scratch(_BF16[x.dtype], r, d, k, int(whole), nbytes)
    return tuple(torch.empty(n, dtype=torch.uint8, device=x.device)
                 for n in nbytes)


def topk_threshold_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest ``|x|`` of each row of (R, D) -> float32 (R,), by the
    kernel's radix select (``select_launches`` launches). Counts each call
    in ``.launches``."""
    r, d = _checked(x, k, "topk_threshold_cuda")
    zeroed, rest = _scratch(x, k, False)
    thresholds = torch.empty(r, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().soar_topk_select(
            x.data_ptr(), _BF16[x.dtype], r, d, k, zeroed.data_ptr(),
            rest.data_ptr(), thresholds.data_ptr(), stream_of(x))
    check(err, "top-k select launch")
    topk_threshold_cuda.launches += 1
    return thresholds


def topk_compress_cuda(x: torch.Tensor, k: int):
    """x (R, D) -> (values (R, k) in x's dtype, indices (R, k) int32) by
    descending ``|x|``, the lower index first on ties. Counts each call in
    ``.launches``."""
    r, d = _checked(x, k, "topk_compress_cuda")
    zeroed, rest = _scratch(x, k, True)
    values = torch.empty((r, k), dtype=x.dtype, device=x.device)
    indices = torch.empty((r, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().soar_topk_compress(
            x.data_ptr(), _BF16[x.dtype], r, d, k, zeroed.data_ptr(),
            rest.data_ptr(), values.data_ptr(), indices.data_ptr(),
            stream_of(x))
    check(err, "top-k kernel launch")
    topk_compress_cuda.launches += 1
    return values, indices


topk_threshold_cuda.launches = 0
topk_compress_cuda.launches = 0
