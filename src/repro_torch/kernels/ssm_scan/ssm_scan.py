"""Launcher of the CUDA selective-SSM scan (``csrc/ssm_scan.cu``).

The port's counterpart of the Pallas ``ssm_chunk_scan_pallas``. Its plain
version is :mod:`repro_torch.kernels.ssm_scan.ref`, with which it agrees
to rounding. It takes float32 only, as the model feeds it (the JAX model
casts every operand of the scan to float32). u, delta, bv and cv may be
strided views whose last dimension is contiguous (the model passes u as
half of its input projection and bv, cv as slices of one (B, T, 2N + 1)
projection, with no copy); a and s0 are contiguous. The final state is
written into ``s_out``, which may be ``s0`` itself: each of the kernel's
threads reads its state before it writes it. Counts each launch in
``.launches``.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of

MAX_STATE = 32                   # N: one warp's lanes at most


def _strides(name: str, t: torch.Tensor, what: str) -> tuple[int, int]:
    """(batch, time) element strides of a (B, T, X) view with X
    contiguous (a length-1 X has no stride to check)."""
    if t.shape[2] > 1 and t.stride(2) != 1:
        raise ValueError(f"{what}: {name} needs a contiguous last "
                         f"dimension, got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def ssm_chunk_scan_cuda(u, delta, bv, cv, a, s0, s_out=None):
    """The selective-SSM scan on the card: u (B, T, D), delta (B, T, 1),
    bv/cv (B, T, N), a (D, N), s0 (B, D, N), all float32 -> (y (B, T, D),
    s_final (B, D, N)); ``s_final`` is ``s_out`` when given (``s0``
    allowed). Counts each launch in ``.launches``."""
    what = "ssm_chunk_scan_cuda"
    s_out = torch.empty_like(s0) if s_out is None else s_out
    named = (("u", u), ("delta", delta), ("bv", bv), ("cv", cv), ("a", a),
             ("s0", s0), ("s_out", s_out))
    for name, t in named:
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"{what} needs every operand on one CUDA "
                             f"device, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 only, got {name} "
                            f"{t.dtype}")
    B, T, D = u.shape
    N = bv.shape[-1]
    if delta.shape != (B, T, 1) or bv.shape != (B, T, N) or \
            cv.shape != (B, T, N) or a.shape != (D, N) or \
            s0.shape != (B, D, N) or s_out.shape != (B, D, N):
        raise ValueError(f"{what}: bad shapes u {tuple(u.shape)} delta "
                         f"{tuple(delta.shape)} bv {tuple(bv.shape)} cv "
                         f"{tuple(cv.shape)} a {tuple(a.shape)} s0 "
                         f"{tuple(s0.shape)} s_out {tuple(s_out.shape)}")
    if min(B, T, D, N) < 1 or N > MAX_STATE or B > 65535:
        raise ValueError(f"{what}: needs B, T, D >= 1, 1 <= N <= "
                         f"{MAX_STATE} and B <= 65535, got {(B, T, D, N)}")
    for name, t in (("a", a), ("s0", s0), ("s_out", s_out)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    strides = [x for name, t in named[:4] for x in _strides(name, t, what)]
    y = torch.empty((B, T, D), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = library().soar_ssm_scan(
            u.data_ptr(), delta.data_ptr(), bv.data_ptr(), cv.data_ptr(),
            a.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, T, D, N, *strides, stream_of(u))
    check(err, "ssm scan launch")
    ssm_chunk_scan_cuda.launches += 1
    return y, s_out


ssm_chunk_scan_cuda.launches = 0
