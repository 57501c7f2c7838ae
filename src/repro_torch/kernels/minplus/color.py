"""One level of the on-device SOAR-Color: the chains and the budget split.

For every internal node of a depth level, across all B instances, the
color replays the node's red and blue min-plus chains over its children,
decides blue iff strictly better, and splits the node's budget among its
children, last child first (Algorithm 4's mSplit, with the serial
solver's tie-breaking: the first minimizer). On a CUDA tensor
:func:`color_level` launches the hand-written kernel ``csrc/minplus.cu``
(``color_level_kernel``, one launch per level); on a CPU tensor it runs
:func:`color_level_torch`, the plain torch spelling of the same
arithmetic, which runs every child index of the chain and of the split.
There is no option that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from .levelfold import _fold, minplus_fused
from .minplus import color_level_cuda


def color_level_torch(ch, kid, i, el, rl, load, send, avail, *,
                      kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch color of one level; never launches a kernel.

    ch: (B, W1, nl1, K) the child level's gathered block (first ``kc``
    columns used); kid: (B, Wi, max_c) int64 child-level-local indices in
    [0, W1], W1 the all-zeros identity (appended here); i, el: (B, Wi)
    int64 budgets and barrier rows; rl, load, send: (B, Wi); avail: (B, Wi)
    bool. Returns ``isblue`` (B, Wi) bool and ``split`` (B, Wi, max_c)
    int64: each child's budget, the remainder in column 0.

    Chains at width ``kc`` (reads beyond it land in the flat region of the
    monotone tables, where clamped indexing is exact) run the gather's
    child order, so replayed values match the tables bit for bit.
    """
    B, Wi, max_c = kid.shape
    W1, nl1 = ch.shape[1], ch.shape[2]
    dt, dev = ch.dtype, ch.device
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    jj = torch.arange(kc, device=dev)[None, None, :]
    chf = torch.cat(
        [ch[..., :kc], torch.zeros((B, 1, nl1, kc), dtype=dt, device=dev)],
        dim=1).reshape(B, (W1 + 1) * nl1, kc)

    def slot_rows(row):
        """All children's tables at per-node row: (max_c, B, Wi, kc)."""
        idx = (kid * nl1 + row[:, :, None]).reshape(B, Wi * max_c)
        got = torch.gather(chf, 1, idx[:, :, None].expand(-1, -1, kc))
        return got.reshape(B, Wi, max_c, kc).movedim(2, 0)

    # partial min-plus chains over children, red (row ell+1) and blue
    # (row 1) variants; sentinel children hit the appended identity.
    er = el + 1                  # <= d+2: always inside the child block
    x_r = slot_rows(er)
    x_b = slot_rows(torch.ones_like(er))
    st = torch.cat([x_r.reshape(max_c, B * Wi, kc),
                    x_b.reshape(max_c, B * Wi, kc)], dim=1)
    _, parts = _fold(st, True, minplus_fused)         # (max_c, 2BWi, kc)
    ch_r = parts[:, : B * Wi].reshape(max_c, B, Wi, kc)
    ch_b = parts[:, B * Wi :].reshape(max_c, B, Wi, kc)
    ic = torch.clamp(i, max=kc - 1)                    # flat-region clip
    red_val = torch.gather(ch_r[-1], 2, ic[..., None])[..., 0] + load * rl
    ib = torch.clamp(i - 1, 0, kc - 1)
    blue_val = torch.where(
        avail & (i >= 1),
        torch.gather(ch_b[-1], 2, ib[..., None])[..., 0] + send * rl,
        inf)
    isblue = blue_val < red_val                        # strict, as in serial
    bud = i - isblue.to(torch.int64)
    # split the budget among children, last child first (mSplit replay).
    # Sentinel children read the identity's zero table: their vals are the
    # (monotone non-increasing) partial chain at bud - j, non-decreasing in
    # j, so the first minimizer is j = 0 and the budget passes through.
    sel = isblue[None, :, :, None]
    chain = torch.where(sel, ch_b, ch_r)
    # children see the barrier at row lc = isblue ? 1 : ell+1, both
    # already gathered
    xc = torch.where(sel, x_b, x_r)
    best = []
    for m in range(max_c - 1, 0, -1):
        feas = jj <= bud[..., None]
        vals = torch.gather(chain[m - 1], 2,
                            torch.clamp(bud[..., None] - jj, 0, kc - 1))
        vals = torch.where(feas, vals + xc[m], inf)
        best_j = torch.argmin(vals, dim=2)
        bud = bud - best_j
        best.append(best_j)
    return isblue, torch.stack([bud] + best[::-1], dim=2)


def color_level(ch, kid, i, el, rl, load, send, avail, *,
                kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One level of the color: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors (see module docstring)."""
    if ch.device.type == "cpu":
        return color_level_torch(ch, kid, i, el, rl, load, send, avail,
                                 kc=kc)
    return color_level_cuda(*(t.contiguous() for t in
                              (ch, kid, i, el, rl, load, send, avail)),
                            kc=kc)
