"""Launcher of the CUDA masked group sum (``csrc/segment_reduce.cu``).

The port's counterpart of the Pallas ``segment_reduce_pallas``. Its plain
version is :func:`repro_torch.kernels.segment_reduce.ref.
segment_reduce_torch`, with the same left fold, so the two agree bit for
bit. Besides the (G, C, D) form of the JAX kernel, the launcher takes a
``rows`` index into a (R, D) buffer, so the reduce executor folds the slots
of just the devices an op involves, in place, without copying them out.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of

_ENTRY = {torch.float32: "soar_segment_reduce_f32",
          torch.bfloat16: "soar_segment_reduce_bf16"}
_ALIGN = {torch.float32: 16, torch.bfloat16: 8}   # bytes of 4 values
_MAX_GROUPS = 65535                               # gridDim.y


def segment_reduce_cuda(x: torch.Tensor, mask: torch.Tensor,
                        rows: torch.Tensor | None = None, *,
                        inplace: bool = False,
                        round_each: bool = False) -> torch.Tensor:
    """Launch the kernel: ``out[g, d] = sum_c mask[g, c] * x[g, c, d]``.

    Without ``rows``: ``x`` (G, C, D) -> a new (G, D). With ``rows`` (G,)
    int64 on ``x``'s device: ``x`` is a (R, D) buffer, group g sums rows
    ``rows[g] .. rows[g] + C - 1`` (the kernel reads the unmasked ones
    unchecked, so they must lie in ``[0, R)``), into a new (G, D) or, with
    ``inplace=True``, over row ``rows[g]`` of ``x`` (spans of different
    groups must not overlap). ``x`` is contiguous float32 or bfloat16 on a
    CUDA device; a CPU tensor raises. ``round_each=True`` rounds the sum to
    ``x``'s dtype after every add (bfloat16 addition; for float32 that is
    the default fold). Counts each launch in ``segment_reduce_cuda.launches``.
    """
    if x.device.type != "cuda" or mask.device != x.device:
        raise ValueError(f"segment_reduce_cuda needs CUDA tensors on one "
                         f"device, got {x.device} and {mask.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"segment_reduce_cuda takes float32/bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("segment_reduce_cuda needs a contiguous x")
    if mask.ndim != 2:
        raise ValueError(f"mask must be (G, C), got {tuple(mask.shape)}")
    G, C = mask.shape
    if rows is None:
        if inplace:
            raise ValueError("inplace=True writes over rows; pass rows")
        if x.ndim != 3 or tuple(x.shape[:2]) != (G, C):
            raise ValueError(f"bad shapes {tuple(x.shape)} "
                             f"{tuple(mask.shape)}")
        out = torch.empty((G, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        if x.ndim != 2:
            raise ValueError(f"with rows, x is a (R, D) buffer, got "
                             f"{tuple(x.shape)}")
        if (rows.device != x.device or rows.dtype != torch.int64
                or tuple(rows.shape) != (G,) or not rows.is_contiguous()):
            raise ValueError(f"rows must be a contiguous ({G},) int64 tensor "
                             f"on {x.device}")
        out = x if inplace else torch.empty((G, x.shape[1]), dtype=x.dtype,
                                            device=x.device)
    if G > _MAX_GROUPS:
        raise ValueError(f"{G} groups exceed the kernel's {_MAX_GROUPS}")
    D = x.shape[-1]
    if G == 0 or D == 0:
        return out
    m = mask.to(x.dtype).to(torch.float32).contiguous()
    a = _ALIGN[x.dtype]
    vec = int(D % 4 == 0 and x.data_ptr() % a == 0
              and out.data_ptr() % a == 0)
    rp = 0 if rows is None else rows.data_ptr()
    entry = _ENTRY[x.dtype]
    if round_each and x.dtype == torch.bfloat16:
        entry += "_round_each"
    fn = getattr(library(), entry)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), m.data_ptr(), rp, out.data_ptr(),
                 rp if inplace else 0, G, C, D, vec, stream_of(x))
    check(err, "segment-reduce kernel launch")
    segment_reduce_cuda.launches += 1
    return out


segment_reduce_cuda.launches = 0
