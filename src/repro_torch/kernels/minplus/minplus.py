"""Wrappers of the CUDA min-plus kernels (``csrc/minplus.cu``).

The port's counterparts of the Pallas ``minplus_pallas``: the batched
convolution :func:`minplus_cuda` (``ops.minplus``), whose plain version is
:func:`repro_torch.kernels.minplus.levelfold.minplus_fused` with the same
candidate set, and the color's level kernel :func:`color_level_cuda`, whose
plain version is :func:`repro_torch.kernels.minplus.color.color_level_torch`;
each agrees with its plain version bit for bit. Budget widths are not
padded: the kernels take any K (the TPU's 128-lane padding was a tiling
artefact).
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of

_ENTRY = {torch.float32: "soar_minplus_f32", torch.float64: "soar_minplus_f64"}
_COLOR_ENTRY = {torch.float32: "soar_color_level_f32",
                torch.float64: "soar_color_level_f64"}
#: Shared memory a color-level block may hold in node slabs (each node two
#: chains of partials and children's rows, ``4 * max_c * kc`` values); a
#: node whose slab is larger keeps it in a scratch tensor instead.
COLOR_SMEM_BUDGET = 96 * 1024


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


def color_level_cuda(ch, kid, i, el, rl, load, send, avail, *,
                     kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the color-level kernel; contract of ``color_level_torch``.

    Every operand is a contiguous tensor on one CUDA device; ``kid`` must
    hold indices in [0, W1] (the kernel reads through them unchecked).
    Counts each launch in ``color_level_cuda.launches``.
    """
    B, W1, nl1, ldk = ch.shape
    Wi, max_c = kid.shape[1:]
    dt = ch.dtype
    operands = dict(ch=ch, kid=kid, i=i, el=el, rl=rl, load=load, send=send,
                    avail=avail)
    want = dict(ch=(B, W1, nl1, ldk), kid=(B, Wi, max_c), i=(B, Wi),
                el=(B, Wi), rl=(B, Wi), load=(B, Wi), send=(B, Wi),
                avail=(B, Wi))
    for name, t in operands.items():
        if t.device != ch.device or t.device.type != "cuda":
            raise ValueError(f"color_level_cuda: {name} on {t.device}, "
                             f"needs the CUDA device of ch ({ch.device})")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"color_level_cuda: {name} shape "
                             f"{tuple(t.shape)} != {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"color_level_cuda: {name} is not contiguous")
    if dt not in _COLOR_ENTRY or any(t.dtype != dt
                                     for t in (rl, load, send)):
        raise TypeError("color_level_cuda: ch, rl, load, send must share "
                        "one dtype, float32 or float64")
    if any(t.dtype != torch.int64 for t in (kid, i, el)) or (
            avail.dtype != torch.bool):
        raise TypeError("color_level_cuda: kid, i, el must be int64 and "
                        "avail bool")
    if not 1 <= kc <= ldk:
        raise ValueError(f"color_level_cuda: kc={kc} outside [1, {ldk}]")
    isblue = torch.empty((B, Wi), dtype=torch.bool, device=ch.device)
    split = torch.empty((B, Wi, max_c), dtype=torch.int64, device=ch.device)
    if isblue.numel() == 0:
        return isblue, split
    scratch = None
    if 4 * max_c * kc * ch.element_size() > COLOR_SMEM_BUDGET:
        scratch = torch.empty(B * Wi * 4 * max_c * kc, dtype=dt,
                              device=ch.device)
    fn = getattr(library(), _COLOR_ENTRY[dt])
    with torch.cuda.device(ch.device):
        err = fn(*(t.data_ptr() for t in operands.values()),
                 isblue.data_ptr(), split.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, W1, nl1,
                 ldk, Wi, max_c, kc, COLOR_SMEM_BUDGET, stream_of(ch))
    check(err, "color-level kernel launch")
    color_level_cuda.launches += 1
    return isblue, split


color_level_cuda.launches = 0
