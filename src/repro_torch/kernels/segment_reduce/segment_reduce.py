"""Launcher of the CUDA gather-table segment reduce
(``csrc/segment_reduce.cu``).

The port's counterpart of the Pallas ``segment_reduce_pallas``. Its plain
version is :func:`repro_torch.kernels.segment_reduce.ref.
segment_reduce_torch`, with the same left fold, so the two agree bit for
bit. Besides the (G, C, D) form of the JAX kernel, the launcher takes a
``table`` of rows of a (R0, D) source and a (P, D) scratch of partials, and
writes its sums over rows ``out_rows`` of an output that may be that
scratch: the reduce executor runs a whole program as such launches, with
no slot buffer.
"""
from __future__ import annotations

import torch

from .._build import check, library, stream_of

_ENTRY = {torch.float32: "soar_segment_reduce_f32",
          torch.bfloat16: "soar_segment_reduce_bf16"}
_MAX_GROUPS = 65535                               # gridDim.y
SMS = 132                                         # H100 SXM
MAX_THREADS = 256                                 # a block's threads
MIN_TILE = 256                                    # d a block, narrowest


def tile_of(G: int, D: int, dtype: torch.dtype) -> int:
    """d a block: 256 threads of 16 bytes each (1024 float32, 2048
    bfloat16 values), halved while the grid ``G * ceil(D / tile)`` would
    fill fewer than two waves of the card's SMs, down to ``MIN_TILE``."""
    tile = MAX_THREADS * (128 // torch.finfo(dtype).bits)
    while tile > MIN_TILE and G * -(-D // tile) < 2 * SMS:
        tile //= 2
    return tile


def _on(t: torch.Tensor | None, x: torch.Tensor, what: str) -> None:
    if t is not None and t.device != x.device:
        raise ValueError(f"segment_reduce_cuda needs CUDA tensors on one "
                         f"device, got {x.device} and {t.device} ({what})")


def _index(t: torch.Tensor, shape: tuple, what: str) -> None:
    if (t.dtype != torch.int64 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {shape} int64 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")


def segment_reduce_cuda(x: torch.Tensor, mask: torch.Tensor | None,
                        table: torch.Tensor | None = None, *,
                        scratch: torch.Tensor | None = None,
                        out: torch.Tensor | None = None,
                        out_rows: torch.Tensor | None = None,
                        round_each: bool = False) -> torch.Tensor:
    """Launch the kernel: ``out[out_rows[g]] = fold_c mask[g, c] *
    row(table[g, c])``.

    Without ``table``: ``x`` (G, C, D) and ``mask`` (G, C) -> a new (G, D),
    ``sum_c mask[g, c] * x[g, c]``. With ``table`` (G, C) int64: ``x`` is a
    (R0, D) source, entry ``i < R0`` reads row i of ``x``, ``i >= R0`` row
    ``i - R0`` of ``scratch`` (P, D), -1 reads nothing; ``mask`` is None
    (all ones) or (G, C). The sums go to a new (G, D) or, with ``out``
    (Q, D), over its rows ``out_rows`` (G,) int64 (0..G-1 when None). The
    kernel reads and writes the rows named unchecked: table entries must lie
    in ``[-1, R0 + P)``, out rows in ``[0, Q)`` and distinct, and no row is
    both read and written in one call (``out`` may be ``scratch``). All
    tensors are contiguous and on one CUDA device, ``x``, ``scratch`` and
    ``out`` float32 or bfloat16 of one dtype; a CPU tensor raises.
    ``round_each=True`` rounds the sum to ``x``'s dtype after every add
    (bfloat16 addition; for float32 that is the default fold). Counts each
    launch in ``segment_reduce_cuda.launches``.
    """
    if x.device.type != "cuda":
        raise ValueError(f"segment_reduce_cuda needs CUDA tensors on one "
                         f"device, got {x.device}")
    for t, what in ((mask, "mask"), (table, "table"), (scratch, "scratch"),
                    (out, "out"), (out_rows, "out_rows")):
        _on(t, x, what)
    if x.dtype not in _ENTRY:
        raise TypeError(f"segment_reduce_cuda takes float32/bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("segment_reduce_cuda needs a contiguous x")
    if table is None:
        if mask is None or x.ndim != 3 or tuple(mask.shape) != tuple(
                x.shape[:2]):
            raise ValueError(f"bad shapes {tuple(x.shape)} "
                             f"{None if mask is None else tuple(mask.shape)}")
        G, C = mask.shape
    else:
        if x.ndim != 2:
            raise ValueError(f"with a table, x is a (R0, D) source, got "
                             f"{tuple(x.shape)}")
        if table.ndim != 2:
            raise ValueError(f"table must be (G, C), got {tuple(table.shape)}")
        G, C = table.shape
        _index(table, (G, C), "table")
        if mask is not None and tuple(mask.shape) != (G, C):
            raise ValueError(f"mask must be ({G}, {C}), got "
                             f"{tuple(mask.shape)}")
    D = x.shape[-1]
    for t, what in ((scratch, "scratch"), (out, "out")):
        if t is not None and (t.dtype != x.dtype or t.ndim != 2
                              or t.shape[1] != D or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous (rows, {D}) "
                             f"{x.dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if out is None:
        if out_rows is not None:
            raise ValueError("out_rows names rows of out; pass out")
        out = torch.empty((G, D), dtype=x.dtype, device=x.device)
    elif out_rows is None:
        if out.shape[0] < G:
            raise ValueError(f"out has {out.shape[0]} rows for {G} groups")
    else:
        _index(out_rows, (G,), "out_rows")
    if G > _MAX_GROUPS:
        raise ValueError(f"{G} groups exceed the kernel's {_MAX_GROUPS}")
    if G == 0 or D == 0:
        return out
    m = (None if mask is None
         else mask.to(x.dtype).to(torch.float32).contiguous())
    per = 16 // x.element_size()
    vec = int(D % per == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, scratch, out)
        if t is not None and t.numel()))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    entry = _ENTRY[x.dtype]
    if round_each and x.dtype == torch.bfloat16:
        entry += "_round_each"
    fn = getattr(library(), entry)
    r0 = G * C if table is None else x.shape[0]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), r0, ptr(scratch), ptr(table), ptr(m),
                 out.data_ptr(), ptr(out_rows), G, C, D,
                 tile_of(G, D, x.dtype), vec, stream_of(x))
    check(err, "segment-reduce kernel launch")
    segment_reduce_cuda.launches += 1
    return out


segment_reduce_cuda.launches = 0
