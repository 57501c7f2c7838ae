"""Plain torch version of the masked group sum.

The same arithmetic as the CUDA kernel ``csrc/segment_reduce.cu``: a left
fold over c in ascending order that starts at +0, float32 products and sums
rounded one at a time, rows with a zero mask left out (they change the
accumulator not even by +0), one rounding to the input dtype at the end.
With ``round_each=True`` the accumulator is rounded to the input dtype
after every add instead, as a bfloat16 carry in a JAX ``fori_loop`` is.
It runs on any device and agrees with the kernel bit for bit.
"""
from __future__ import annotations

import torch


def segment_reduce_torch(x: torch.Tensor, mask: torch.Tensor,
                         rows: torch.Tensor | None = None, *,
                         round_each: bool = False) -> torch.Tensor:
    """``out[g, d] = sum_c mask[g, c] * x[g, c, d]`` -> (G, D).

    Without ``rows``, ``x`` is (G, C, D). With ``rows`` (G,) int64, ``x``
    is a (R, D) buffer and group g's c-th row is ``x[rows[g] + c]``; rows
    whose mask is 0 may lie past the end of ``x``. ``mask`` (G, C) is cast
    to ``x``'s dtype first, as the JAX package's oracle does.
    """
    G, C = mask.shape
    m = mask.to(x.dtype).to(torch.float32)
    acc = torch.zeros((G, x.shape[-1]), dtype=torch.float32, device=x.device)
    for c in range(C):
        if rows is None:
            xc = x[:, c]
        else:
            xc = x.index_select(0, (rows + c).clamp(max=x.shape[0] - 1))
        mc = m[:, c : c + 1]
        acc = torch.where(mc != 0, acc + mc * xc.to(torch.float32), acc)
        if round_each:
            acc = acc.to(x.dtype).to(torch.float32)
    return acc.to(x.dtype)


def reduce_rows_torch(flat: torch.Tensor, mask: torch.Tensor,
                      rows: torch.Tensor, *,
                      inplace: bool = False) -> torch.Tensor:
    """Plain version of the executor's Reduce over row spans of a (R, D)
    buffer (see :func:`repro_torch.kernels.segment_reduce.ops.reduce_rows`):
    the (G, D) sums, rounded after every add, or with ``inplace=True`` each
    written over its span's first row ``flat[rows[g]]`` (all spans read
    before any is written)."""
    out = segment_reduce_torch(flat, mask, rows, round_each=True)
    return flat.index_copy_(0, rows, out) if inplace else out
