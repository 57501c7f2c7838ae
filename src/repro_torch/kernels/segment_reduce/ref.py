"""Plain torch version of the gather-table segment reduce.

The same arithmetic as the CUDA kernel ``csrc/segment_reduce.cu``: a left
fold over c in ascending order that starts at +0, float32 products and sums
rounded one at a time, entries of -1 and rows with a zero mask left out
(they change the accumulator not even by +0), one rounding to the input
dtype at the end. With ``round_each=True`` the accumulator is rounded to the
input dtype after every add instead, as a bfloat16 carry in a JAX
``fori_loop`` is. It runs on any device and agrees with the kernel bit for
bit.
"""
from __future__ import annotations

import torch


def gather_rows(x: torch.Tensor, scratch: torch.Tensor | None,
                idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[g]`` of x stacked over scratch, for each g (entries that
    name no row give some row; the caller masks them)."""
    r0 = x.shape[0]
    if scratch is None or scratch.shape[0] == 0:
        return x.index_select(0, idx.clamp(0, max(r0 - 1, 0)))
    from_s = scratch.index_select(
        0, (idx - r0).clamp(0, scratch.shape[0] - 1))
    if r0 == 0:
        return from_s
    from_x = x.index_select(0, idx.clamp(0, r0 - 1))
    return torch.where((idx >= r0)[:, None], from_s, from_x)


def segment_reduce_torch(x: torch.Tensor, mask: torch.Tensor | None,
                         table: torch.Tensor | None = None, *,
                         scratch: torch.Tensor | None = None,
                         out: torch.Tensor | None = None,
                         out_rows: torch.Tensor | None = None,
                         round_each: bool = False) -> torch.Tensor:
    """``out[out_rows[g]] = fold_c mask[g, c] * row(table[g, c])``.

    Without ``table``, ``x`` is (G, C, D) and the result is the (G, D)
    ``sum_c mask[g, c] * x[g, c]`` (the table ``g * C + c`` over
    ``x.view(G * C, D)``). With ``table`` (G, C) int64, ``x`` is a (R0, D)
    source: entry ``i < R0`` names row i of x, entry ``i >= R0`` row
    ``i - R0`` of the (P, D) ``scratch``, and -1 names nothing. ``mask``
    (G, C) is cast to ``x``'s dtype first, as the JAX package's oracle does;
    None is all ones. Returns the (G, D) sums or, with ``out``, writes them
    over rows ``out_rows`` (rows 0..G-1 when None) of ``out`` after every
    sum is taken, and returns ``out``.
    """
    if table is None:
        G, C, D = x.shape
        src = x.reshape(G * C, D)
        table = torch.arange(G * C, device=x.device).view(G, C)
    else:
        G, C = table.shape
        src = x
    if mask is None:
        m = torch.ones((G, C), dtype=torch.float32, device=x.device)
    else:
        m = mask.to(x.dtype).to(torch.float32)
    acc = torch.zeros((G, x.shape[-1]), dtype=torch.float32, device=x.device)
    for c in range(C):
        idx = table[:, c]
        mc = m[:, c : c + 1]
        xc = gather_rows(src, scratch, idx)
        read = (mc != 0) & (idx >= 0)[:, None]
        acc = torch.where(read, acc + mc * xc.to(torch.float32), acc)
        if round_each:
            acc = acc.to(x.dtype).to(torch.float32)
    res = acc.to(x.dtype)
    if out is None:
        return res
    if out_rows is None:
        out[:G] = res
    else:
        out.index_copy_(0, out_rows, res)
    return out
