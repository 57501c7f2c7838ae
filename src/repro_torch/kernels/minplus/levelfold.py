"""Fused level fold: one launch per tree level of the batched SOAR-Gather.

For every internal node of a depth level, across all B instances, the fold
chains the min-plus convolutions of its children's DP tables (the mCost
chain of Algorithm 3), applies the red/blue recurrence and the at-most-k
``cummin``. On a CUDA tensor :func:`level_fold` launches the hand-written
kernel ``csrc/levelfold.cu`` (the counterpart of the Pallas
``level_fold_pallas``); on a CPU tensor it runs :func:`level_fold_torch`,
the plain torch spelling of the same arithmetic. There is no option that
sends a CUDA tensor to the plain version.

Bit identity between the two, and with the JAX package, rests on three
orders that this module fixes: the candidate set of :func:`minplus_fused`
(each candidate one rounded add, reduced by an exact ``min``), the child
order of :func:`chain_fold` (child 0 first, left to right), and the
per-hop left-to-right accumulation of :func:`rho_up_from_edges`. Products
and sums are separate roundings; nothing is contracted to a fused
multiply-add. All arithmetic runs on the finite ``BIG`` sentinel, never
``inf``: padded slots multiply by zero loads, and ``0 * inf`` is NaN.
"""
from __future__ import annotations

from typing import Callable

import torch

from ...core.tropical import BIG
from .._build import check, library, stream_of
from .minplus import minplus_cuda


def minplus_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Min-plus convolution, (rows, K) x (rows, K) -> (rows, K).

    The j-shift reduction: ``a + b[:, :1]``, then for j = 1..K-1 the
    minimum with ``a`` shifted right by j (``BIG`` shifted in) plus
    ``b[:, j]``. The plain version of both CUDA kernels' inner loop.
    """
    rows, k = a.shape
    acc = a + b[:, :1]
    for j in range(1, k):
        shifted = torch.cat(
            [a.new_full((rows, j), BIG), a[:, : k - j]], dim=1)
        acc = torch.minimum(acc, shifted + b[:, j : j + 1])
    return acc


def identity_steps(acc: torch.Tensor, r: int) -> torch.Tensor:
    """``r`` chain steps against the all-zeros identity child, in closed
    form: bitwise equal to ``r`` repeated ``minplus_fused(acc, zeros)``.

    With ``pm`` the prefix minimum of ``acc + 0``, one step gives
    ``min(pm, BIG)`` below the last entry and ``pm`` at it: ``a + 0`` is
    exact, and the shifted-in ``BIG + 0`` candidate exists only for
    i < K-1. A second step caps the last entry as well, and further steps
    change nothing; for K = 1 every step returns ``acc + 0``. Both kernels
    fold a run of sentinel children this way, never with a K*K step.
    """
    if r < 1:
        return acc
    pm = torch.cummin(acc + 0.0, dim=-1).values
    if pm.shape[-1] == 1:
        return pm
    capped = torch.minimum(pm, pm.new_tensor(BIG))
    if r >= 2:
        return capped
    return torch.cat([capped[..., :-1], pm[..., -1:]], dim=-1)


def _fold(st: torch.Tensor, collect: bool,
          step: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    acc = st[0]
    parts = [acc]
    for m in range(1, st.shape[0]):
        acc = step(acc, st[m])
        parts.append(acc)
    if not collect:
        return acc
    return acc, torch.stack(parts)


def chain_fold(st: torch.Tensor, collect: bool = False):
    """Fold a stack of row-batches through the min-plus chain.

    ``st``: (max_c, R, K), child 0 first. Returns the final accumulator
    (R, K), plus with ``collect=True`` the (max_c, R, K) stack of partial
    chains (the color's mSplit replay reads them). On a CUDA tensor each
    step is one launch of the standalone min-plus kernel; on a CPU tensor
    it is :func:`minplus_fused`. The gather's fold and the color's replay
    (``color.color_level_torch`` and its kernel) chain in this order,
    which keeps their values bit-identical.
    """
    step = minplus_fused if st.device.type == "cpu" else minplus_cuda
    return _fold(st, collect, step)


def rho_up_from_edges(rho_edge: torch.Tensor, anc: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The packed rho-up table from per-edge rates, on the tensors' device:

        rho_up[b, s, ell] = sum_{j < ell} rho_edge[b, anc[b, s, j]]

    ``rho_edge``: (B, S), finite everywhere (0 at padded slots); ``anc``:
    (B, S, h_max+1) int64, the slot of the j-th ancestor (j=0 is s itself,
    slot 0 past the root); ``valid``: (B, S, h_max+2) bool, True where the
    host table is finite. Returns (B, S, h_max+2) with ``BIG`` at invalid
    entries. One edge per hop, left to right, as the host
    ``Tree.rho_up_table`` walk adds them: never a parallel scan.
    """
    acc = torch.zeros_like(rho_edge)
    rows = [torch.where(valid[:, :, 0], acc, BIG)]
    for ell in range(1, valid.shape[2]):
        acc = acc + torch.gather(rho_edge, 1, anc[:, :, ell - 1])
        rows.append(torch.where(valid[:, :, ell], acc, BIG))
    return torch.stack(rows, dim=2)


def scaled_edges(rho_edge: torch.Tensor, scale: torch.Tensor,
                 extra: torch.Tensor | None = None,
                 root_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Effective per-edge rates ``rho_edge * scale``, optionally plus an
    additive ``extra`` (B,) on each instance's root edge (column
    ``root_idx`` (B,) int64): the fleet driver's shared-core transit, in
    series with the root hop. Multiplied first, then extended, as the JAX
    package does.
    """
    edges = rho_edge * scale
    if extra is None:
        return edges
    rows = torch.arange(edges.shape[0], device=edges.device)
    return edges.index_put((rows, root_idx), extra, accumulate=True)


def level_fold_torch(xs, xb, kid, load, send, avail, rho, *, nl: int,
                     kcap: int) -> torch.Tensor:
    """Plain torch level fold, the counterpart of ``level_fold_jnp``.

    xs: (B, C, nl, kcap) the child level's tables at rows 1..nl, all-zeros
    identity at index C-1; xb: (B, C, kcap) the same at row 1 (the blue
    chain's operand); kid: (B, W, max_c) int64 child-level-local indices
    in [0, C) (sentinel C-1); load, send: (B, W); avail: (B, W) bool; rho:
    (B, W, nl). Returns the level's internal block, (B, W, nl, kcap).
    Runs on any device and never launches a kernel of this package.
    """
    B, W, max_c = kid.shape
    idx = kid.reshape(B, W * max_c)
    g_r = torch.gather(xs, 1, idx[:, :, None, None].expand(-1, -1, nl, kcap))
    g_b = torch.gather(xb, 1, idx[:, :, None].expand(-1, -1, kcap))
    rows_r = g_r.reshape(B, W, max_c, nl, kcap).movedim(2, 0).reshape(
        max_c, B * W * nl, kcap)
    rows_b = g_b.reshape(B, W, max_c, kcap).movedim(2, 0).reshape(
        max_c, B * W, kcap)
    acc = _fold(torch.cat([rows_r, rows_b], dim=1), False, minplus_fused)
    acc_r = acc[: B * W * nl].reshape(B, W, nl, kcap)
    acc_b = acc[B * W * nl :].reshape(B, W, kcap)
    rl = rho[..., None]                                # (B, W, nl, 1)
    red = acc_r + load[:, :, None, None] * rl
    # blue: the budget shifts by one (v spends a slot on itself)
    blue = torch.cat(
        [xs.new_full((B, W, nl, 1), BIG),
         acc_b[:, :, None, :-1] + send[:, :, None, None] * rl], dim=-1)
    blue = torch.where(avail[:, :, None, None], blue, BIG)
    return torch.cummin(torch.minimum(red, blue), dim=3).values


_LEVELFOLD_ENTRY = {torch.float32: "soar_levelfold_f32",
                    torch.float64: "soar_levelfold_f64"}


def level_fold_cuda(xs, xb, kid, load, send, avail, rho, *, nl: int,
                    kcap: int) -> torch.Tensor:
    """Launch the level-fold kernel; contract of :func:`level_fold_torch`.

    Every operand is a contiguous tensor on one CUDA device; ``kid`` must
    hold indices in [0, C) (the kernel reads through them unchecked).
    Counts each launch in ``level_fold_cuda.launches``.
    """
    B, C = xs.shape[:2]
    W, max_c = kid.shape[1:]
    dt = xs.dtype
    operands = dict(xs=xs, xb=xb, kid=kid, load=load, send=send,
                    avail=avail, rho=rho)
    want = dict(xs=(B, C, nl, kcap), xb=(B, C, kcap), kid=(B, W, max_c),
                load=(B, W), send=(B, W), avail=(B, W), rho=(B, W, nl))
    for name, t in operands.items():
        if t.device != xs.device or t.device.type != "cuda":
            raise ValueError(f"level_fold_cuda: {name} on {t.device}, "
                             f"needs the CUDA device of xs ({xs.device})")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"level_fold_cuda: {name} shape "
                             f"{tuple(t.shape)} != {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"level_fold_cuda: {name} is not contiguous")
    if dt not in _LEVELFOLD_ENTRY or any(
            t.dtype != dt for t in (xb, load, send, rho)):
        raise TypeError("level_fold_cuda: xs, xb, load, send, rho must "
                        "share one dtype, float32 or float64")
    if kid.dtype != torch.int64 or avail.dtype != torch.bool:
        raise TypeError(f"level_fold_cuda: kid must be int64 and avail "
                        f"bool, got {kid.dtype} and {avail.dtype}")
    out = torch.empty((B, W, nl, kcap), dtype=dt, device=xs.device)
    if out.numel() == 0:
        return out
    fn = getattr(library(), _LEVELFOLD_ENTRY[dt])
    with torch.cuda.device(xs.device):
        err = fn(*(t.data_ptr() for t in operands.values()), out.data_ptr(),
                 B, C, W, max_c, nl, kcap, stream_of(xs))
    check(err, "level-fold kernel launch")
    level_fold_cuda.launches += 1
    return out


level_fold_cuda.launches = 0


def level_fold(xs, xb, kid, load, send, avail, rho, *, nl: int,
               kcap: int) -> torch.Tensor:
    """The fused level fold: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors (see module docstring)."""
    if xs.device.type == "cpu":
        return level_fold_torch(xs, xb, kid, load, send, avail, rho,
                                nl=nl, kcap=kcap)
    return level_fold_cuda(*(t.contiguous() for t in
                             (xs, xb, kid, load, send, avail, rho)),
                           nl=nl, kcap=kcap)
