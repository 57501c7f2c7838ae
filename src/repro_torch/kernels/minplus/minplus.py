"""Wrapper of the CUDA batched min-plus kernel (``csrc/minplus.cu``).

The port's counterpart of the Pallas ``minplus_pallas``. Budget widths are
not padded: the kernel takes any K (the TPU's 128-lane padding was a
tiling artefact). The plain version is
:func:`repro_torch.kernels.minplus.levelfold.minplus_fused`, with the same
candidate set, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of

_ENTRY = {torch.float32: "soar_minplus_f32", torch.float64: "soar_minplus_f64"}


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the min-plus kernel: (rows, K) x (rows, K) -> (rows, K).

    ``a`` and ``b`` are contiguous CUDA tensors of one float dtype (float32
    or float64). Counts each launch in ``minplus_cuda.launches``.
    """
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"minplus_cuda needs CUDA tensors on one device, "
                         f"got {a.device} and {b.device}")
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"minplus_cuda takes float32/float64, got "
                        f"{a.dtype} and {b.dtype}")
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus_cuda needs contiguous operands")
    rows, k = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    fn = getattr(library(), _ENTRY[a.dtype])
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, k,
                 stream_of(a))
    check(err, "minplus kernel launch")
    minplus_cuda.launches += 1
    return out


minplus_cuda.launches = 0
