"""Batched multi-tenant SOAR placement engine (PyTorch), device-resident.

Solves B phi-BIC instances at once over the level-packed
:class:`repro_torch.core.forest.Forest` layout. Both halves of SOAR run on
the device, and only the answers cross back to the host:

  * **Gather**: a level-synchronous sweep, deepest level first, where all
    nodes of a depth level across *all* instances are processed together.
    The budget-split min over children (the mCost tropical convolution of
    Algorithm 3) runs through the fused level fold
    (``repro_torch.kernels.minplus.levelfold``): one CUDA kernel launch
    per level. Convolution widths are truncated per level to the
    ``min(k, subtree size)`` knapsack bound (``Forest.lvl_sub``) and
    flat-padded back, exact for the monotone at-most-k tables. Each level
    is a contiguous slot block, so results land as per-level tensors.
  * **Color**: a top-down level-synchronous traceback over the same packed
    layout replays each node's budget split against the resident tables
    with the serial solver's tie-breaking (blue iff strictly better; first
    minimizer per child split). Each level's chains and split run through
    ``repro_torch.kernels.minplus.color``: one CUDA kernel launch per level
    with internal nodes. Each level publishes its split matrix and the next
    level gathers its budget and barrier distance through inverse parent
    pointers; no backpointers are stored.

Only the ``(B, n_max)`` blue masks and ``(B,)`` costs come back to the host
(``BatchResult.bytes_to_host``); ``debug_tables=True`` pulls the whole
table back and colors it on the host with :func:`color_batch` instead.

``EngineOptions.device`` picks the device, "cuda" by default. On a CUDA
device the level fold and the color's level kernel are the hand-written
kernels and nothing else; with ``device="cpu"`` the same sweep runs their
plain torch versions. Asking for CUDA where there is no card raises.

Numerics: the DP runs on the finite ``BIG`` sentinel instead of ``inf`` so
that ``0 * BIG`` stays finite. Tables are float32 by default; instances
whose rho values are exactly representable (dyadic rates) reproduce the
float64 serial reference bit-exactly, other rates to float32 eps; pass
``dtype=torch.float64`` for exactness on arbitrary rates. The min-plus
identity is the all-zeros vector: for monotone A,
``minplus(A, 0)[i] = min_{j<=i} A[i-j] = A[i]``, so missing children (the
identity slot) fold as no-ops.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Sequence

import numpy as np
import torch

from ..core.forest import Forest, build_forest, layout_stats
from ..core.tree import Tree
from ..core.tropical import BIG, minplus_batch
from ..kernels._build import built_kernels
from ..kernels.minplus.color import color_level
from ..kernels.minplus.levelfold import (level_fold, rho_up_from_edges,
                                         scaled_edges)
from .options import EngineOptions, resolve_options


def _gather_packed(
    pk_kid: torch.Tensor,     # (B, S, max_c) int64 child slots, sentinel S
    pk_load: torch.Tensor,    # (B, S)
    pk_send: torch.Tensor,    # (B, S)
    pk_avail: torch.Tensor,   # (B, S) bool
    pk_rho_up: torch.Tensor,  # (B, S, h_max+2), BIG at invalid ell
    *,
    lvl_off: tuple,
    lvl_width: tuple,
    lvl_internal: tuple,
    lvl_sub: tuple,
    k: int,
    cap: bool,
) -> list:
    """Level-synchronous batched SOAR-Gather over the packed slot layout.

    Returns the DP tables as per-level **blocks** ``blocks[d]`` of shape
    ``(B, W_d, d+2, k+1)`` (level d's slots, their valid barrier rows
    0..d+1): a node's children live exactly one level down, so each fold
    reads only the adjacent block. Padded slots hold finite garbage that
    is never read back. With ``cap=True`` each level's fold runs at the
    truncated width ``min(k, lvl_sub[d]) + 1`` and is flat-padded to k+1
    (exact: monotone tables are constant beyond their subtree's budget).
    """
    B = pk_kid.shape[0]
    h_max = pk_rho_up.shape[2] - 2
    K = k + 1
    dt = pk_rho_up.dtype
    dev = pk_rho_up.device
    loadf = pk_load.to(dt)
    sendf = pk_send.to(dt)

    blocks: list = [None] * (h_max + 1)
    for d in range(h_max, -1, -1):
        o, W, Wi = lvl_off[d], lvl_width[d], lvl_internal[d]
        nl = d + 2                                     # valid rows 0..d+1
        if W == 0:                                     # bucketed tail level
            blocks[d] = torch.zeros((B, 0, nl, K), dtype=dt, device=dev)
            continue
        Kd = min(K, lvl_sub[d] + 1) if cap else K
        rl = pk_rho_up[:, o : o + W, :nl, None]        # (B, W, nl, 1)
        parts = []
        if Wi > 0:
            # red chain: children see the barrier one hop further, so child
            # rows 1..nl align with our rows 0..nl-1. Children are addressed
            # level-locally, the all-zeros identity appended at index W1.
            o1, W1 = lvl_off[d + 1], lvl_width[d + 1]
            ch = blocks[d + 1]
            xs = torch.cat(
                [ch[:, :, 1 : nl + 1, :Kd],
                 torch.zeros((B, 1, nl, Kd), dtype=dt, device=dev)], dim=1)
            xb = torch.cat(
                [ch[:, :, 1, :Kd],
                 torch.zeros((B, 1, Kd), dtype=dt, device=dev)], dim=1)
            kid_local = torch.clamp(pk_kid[:, o : o + Wi] - o1, max=W1)
            out = level_fold(
                xs, xb, kid_local, loadf[:, o : o + Wi],
                sendf[:, o : o + Wi], pk_avail[:, o : o + Wi],
                pk_rho_up[:, o : o + Wi, :nl], nl=nl, kcap=Kd)
            if Kd < K:                                 # flat-pad (monotone)
                out = torch.cat(
                    [out, out[..., -1:].expand(B, Wi, nl, K - Kd)], dim=-1)
            parts.append(out)
        if W - Wi > 0:
            # leaves: X_v(l, 0) = L(v) rho; X_v(l, i>=1) also allows blue
            lo = o + Wi
            rll = rl[:, Wi:]
            lr = loadf[:, lo : o + W, None, None] * rll    # (B, Wl, nl, 1)
            sr = sendf[:, lo : o + W, None, None] * rll
            rest = torch.where(pk_avail[:, lo : o + W, None, None],
                               torch.minimum(lr, sr), lr)
            parts.append(torch.cat(
                [lr, rest.expand(*rest.shape[:3], K - 1)], dim=-1))
        blocks[d] = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return blocks


def _color_body(
    blocks: list,               # per-level gather blocks, see _gather_packed
    pk_kid: torch.Tensor,       # (B, S, max_c) int64 child slots, sentinel S
    pk_par: torch.Tensor,       # (B, S) int64 parent's index in its block
    pk_cidx: torch.Tensor,      # (B, S) int64 own index in parent's kids
    pk_load: torch.Tensor,      # (B, S)
    pk_send: torch.Tensor,      # (B, S)
    pk_avail: torch.Tensor,     # (B, S) bool
    pk_rho_up: torch.Tensor,    # (B, S, H2), BIG at invalid ell
    root_slot: torch.Tensor,    # (B,) int64
    *,
    lvl_off: tuple,
    lvl_width: tuple,
    lvl_internal: tuple,
    lvl_sub: tuple,
    k: int,
    cap: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device SOAR-Color: top-down level-synchronous traceback.

    Returns the ``(B, n_slots)`` *slot-indexed* blue mask and the ``(B,)``
    costs. Replays Algorithm 4's budget split against the resident level
    blocks with the tie-breaking of the serial ``soar_color``: blue iff
    *strictly* better, and the *first* minimizer of each child split
    (``torch.argmin`` returns the first index of the minimum). Each level
    stores its internal nodes' split matrix and the next level gathers its
    budget and barrier distance through ``pk_par`` / ``pk_cidx``. The
    replayed chains run at the level's ``min(k, lvl_sub[d]) + 1`` width
    (reads beyond it land in the flat region of the monotone tables, where
    clamped indexing is exact). Leaves skip chains and splits: their blue
    test is elementwise.
    """
    B, _, max_c = pk_kid.shape
    K = k + 1
    dt = blocks[0].dtype
    dev = blocks[0].device
    loadf = pk_load.to(dt)
    sendf = pk_send.to(dt)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)

    blue_parts = []
    prev_split = prev_lc = None      # prev level's child budgets / barrier
    for d, (o, W, Wi) in enumerate(zip(lvl_off, lvl_width, lvl_internal)):
        if W == 0:
            continue                 # bucketed heights: only trailing levels
        if d == 0:
            ids = o + torch.arange(W, device=dev)[None, :]
            i = torch.where(ids == root_slot[:, None], k, 0)
            el = torch.ones((B, W), dtype=torch.int64, device=dev)
        else:
            pl = pk_par[:, o : o + W]
            i = torch.gather(prev_split, 1, pl * max_c + pk_cidx[:, o : o + W])
            el = torch.gather(prev_lc, 1, pl)
        rl = torch.gather(pk_rho_up[:, o : o + W], 2, el[:, :, None])[..., 0]
        if Wi < W:
            # leaves: no children to chain or split, an elementwise test
            red_l = loadf[:, o + Wi : o + W] * rl[:, Wi:]
            can_blue = pk_avail[:, o + Wi : o + W] & (i[:, Wi:] >= 1)
            blue_l = torch.where(can_blue,
                                 sendf[:, o + Wi : o + W] * rl[:, Wi:], inf)
            leaf_blue = blue_l < red_l
        if Wi == 0:
            blue_parts.append(leaf_blue)
            continue                 # leaf-only level: nothing deeper
        Kc = min(K, lvl_sub[d] + 1) if cap else K
        o1, W1 = lvl_off[d + 1], lvl_width[d + 1]
        el_in = el[:, :Wi]
        isblue, split = color_level(
            blocks[d + 1], torch.clamp(pk_kid[:, o : o + Wi] - o1, max=W1),
            i[:, :Wi], el_in, rl[:, :Wi], loadf[:, o : o + Wi],
            sendf[:, o : o + Wi], pk_avail[:, o : o + Wi], kc=Kc)
        blue_parts.append(isblue if Wi == W else
                          torch.cat([isblue, leaf_blue], dim=1))
        # children see the barrier at row lc = isblue ? 1 : ell+1
        lc = torch.where(isblue, 1, el_in + 1)
        prev_split = split.reshape(B, Wi * max_c)
        prev_lc = lc

    costs = blocks[0][torch.arange(B, device=dev), root_slot - lvl_off[0], 1, k]
    blue_slots = torch.cat(blue_parts, dim=1)          # blocks are ordered
    return blue_slots, costs


def slots_to_nodes(blue_slots: torch.Tensor,
                   slot_of: torch.Tensor) -> torch.Tensor:
    """Slot-indexed per-node values -> node-indexed, False/0 at padding.

    ``slot_of`` maps node -> slot with ``n_slots`` at padded nodes; one
    zero column is appended so padded nodes read the neutral element.
    """
    pad = torch.cat([blue_slots, blue_slots.new_zeros((blue_slots.shape[0], 1))],
                    dim=1)
    return torch.gather(pad, 1, slot_of)


def _color_packed(blocks, pk_kid, pk_par, pk_cidx, pk_load, pk_send,
                  pk_avail, pk_rho_up, root_slot, slot_of, *, lvl_off,
                  lvl_width, lvl_internal, lvl_sub, k, cap):
    """:func:`_color_body` returning the node-indexed ``(B, n_max)`` blue
    mask and the ``(B,)`` costs, the only tensors a caller pulls back."""
    blue_slots, costs = _color_body(
        blocks, pk_kid, pk_par, pk_cidx, pk_load, pk_send, pk_avail,
        pk_rho_up, root_slot, lvl_off=lvl_off, lvl_width=lvl_width,
        lvl_internal=lvl_internal, lvl_sub=lvl_sub, k=k, cap=cap)
    return slots_to_nodes(blue_slots, slot_of), costs


def _device(name: str) -> torch.device:
    """The solve's device; CUDA must be present when it is asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the solve runs on CUDA by default and no CUDA device is "
            "available; pass options=EngineOptions(device='cpu') to run "
            "the plain torch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


_INPUT_CACHE: dict[tuple, tuple] = {}


def _cached(cache: dict, f: Forest, dtype, dev: torch.device, make):
    """Per-(Forest identity, dtype, device) cache of uploaded tensors,
    dropped when the Forest is collected. Built Forests are immutable;
    mutating one's numpy arrays in place after a solve would reuse the
    stale device copies, so rebuild via :func:`build_forest` instead."""
    key = (id(f), str(dtype), str(dev))
    hit = cache.get(key)
    if hit is not None and hit[0]() is f:
        return hit[1]
    val = make()
    cache[key] = (weakref.ref(f, lambda _, k=key: cache.pop(k, None)), val)
    return val


def _device_inputs(f: Forest, dtype, dev: torch.device) -> tuple:
    """One host->device upload of the packed arrays (shared gather/color).

    Returns ``(kid, load, send, avail, rho, par, cidx, slot_of,
    root_slot)``: the first five feed the gather, the rest the color.
    Indices are int64 (what ``torch.gather`` takes); ``inf`` in the rho-up
    table becomes ``BIG``. A serving loop re-solving one built Forest
    uploads it once.
    """
    def up(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    def make():
        return (up(f.pk_kid, torch.int64), up(f.pk_load), up(f.pk_send),
                up(f.pk_avail),
                up(np.where(np.isfinite(f.pk_rho_up), f.pk_rho_up, BIG),
                   dtype),
                up(f.pk_par, torch.int64), up(f.pk_cidx, torch.int64),
                up(f.slot_of, torch.int64),
                up(f.slot_of[np.arange(f.batch), f.root], torch.int64))
    return _cached(_INPUT_CACHE, f, dtype, dev, make)


_OVERRIDE_CACHE: dict[tuple, tuple] = {}


def _override_inputs(f: Forest, dtype, dev: torch.device) -> tuple:
    """Device tensors for re-solving ``f`` under effective-rho overrides.

    Returns ``(base_edge, anc, valid, sn, real)``:

      * ``base_edge`` (B, S): each slot's own up-edge rho, 0 at padding;
      * ``anc`` (B, S, h_max+1) int64: slot of the j-th ancestor of slot s
        (j=0 is s itself; slot 0 past the root);
      * ``valid`` (B, S, h_max+2) bool: where ``pk_rho_up`` is finite;
      * ``sn`` / ``real`` (B, S): clipped ``slot_node`` and its validity,
        for gathering node-indexed scale factors into slot order.

    With :func:`rho_up_from_edges` these rebuild the packed rho-up table
    on the device from scaled edge rates, without repacking. Cached like
    :func:`_device_inputs`.
    """
    def make():
        B, S = f.slot_node.shape
        bix = np.arange(B)[:, None]
        valid = np.isfinite(f.pk_rho_up)
        anc = np.zeros((B, S, f.h_max + 1), np.int64)
        cur = f.slot_node.copy()                  # node id walk, -1 done
        for j in range(f.h_max + 1):
            alive = cur >= 0
            idx = np.maximum(cur, 0)
            anc[:, :, j] = np.where(alive, f.slot_of[bix, idx], 0)
            cur = np.where(alive, f.parent[bix, idx], -1)
        base = np.where(valid[:, :, 1], f.pk_rho_up[:, :, 1], 0.0)
        return (torch.as_tensor(base, dtype=dtype, device=dev),
                torch.as_tensor(anc, device=dev),
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(np.maximum(f.slot_node, 0), dtype=torch.int64,
                                device=dev),
                torch.as_tensor(f.slot_node >= 0, device=dev))
    return _cached(_OVERRIDE_CACHE, f, dtype, dev, make)


def _slot_scale(base_edge, sn, real, scale):
    return torch.where(real, torch.gather(scale.to(base_edge.dtype), 1, sn),
                       1.0)


def _override_rho(base_edge, anc, valid, sn, real, scale):
    """Effective packed rho-up table for a node-indexed scale factor."""
    return rho_up_from_edges(
        scaled_edges(base_edge, _slot_scale(base_edge, sn, real, scale)),
        anc, valid)


def _override_rho_add(base_edge, anc, valid, sn, real, scale, extra,
                      root_slot):
    """:func:`_override_rho` plus a per-instance additive root-edge term
    ``extra`` (B,) on slot ``root_slot`` (B,) (see ``scaled_edges``)."""
    edges = scaled_edges(base_edge, _slot_scale(base_edge, sn, real, scale),
                         extra.to(base_edge.dtype), root_slot)
    return rho_up_from_edges(edges, anc, valid)


def _gather_device(f: Forest, k: int, cap: bool, inputs: tuple) -> list:
    """Run the resident gather; returns the per-level device table blocks."""
    kid, load, send, avail, R = inputs[:5]
    return _gather_packed(
        kid, load, send, avail, R,
        lvl_off=f.lvl_off, lvl_width=f.lvl_width,
        lvl_internal=f.lvl_internal, lvl_sub=f.lvl_sub, k=k, cap=bool(cap))


def _unpack_tables(f: Forest, blocks: list) -> np.ndarray:
    """Per-level device blocks -> node-indexed host float64 tables.

    The ``debug_tables=True`` path: pulls the *entire* DP table back. Rows
    beyond a level's ``depth+1`` are BIG (never read); index ``n_max`` is
    the all-zeros identity table sentinel children point at.
    """
    B, S = f.batch, f.n_slots
    H2 = f.h_max + 2
    K = blocks[0].shape[-1]
    Xh = np.full((B, S + 1, H2, K), BIG, np.float64)
    for d, blk in enumerate(blocks):
        o, W = f.lvl_off[d], f.lvl_width[d]
        if W:
            Xh[:, o : o + W, : d + 2] = blk.cpu().numpy().astype(np.float64)
    Xh[:, S] = 0.0
    idx = np.concatenate(
        [f.slot_of, np.full((B, 1), S, np.int32)], axis=1)
    return Xh[np.arange(B)[:, None], idx]


def gather_batch(f: Forest, k: int, *,
                 options: EngineOptions | None = None) -> np.ndarray:
    """Batched SOAR-Gather; returns *node-indexed* DP tables.

    Shape ``(B, n_max+1, h_max+2, k+1)`` float64 on the host; index
    ``n_max`` is the all-zeros identity slot. Debug/inspection API: the
    solve path keeps tables on the device.
    """
    opts = resolve_options(options, {}, "gather_batch")
    dev = _device(opts.device)
    return _unpack_tables(f, _gather_device(
        f, k, opts.cap, _device_inputs(f, opts.dtype, dev)))


def color_batch(f: Forest, X: np.ndarray, k: int) -> np.ndarray:
    """Host-numpy SOAR-Color over *node-indexed* gathered tables.

    The ``debug_tables=True`` traceback and the parity oracle of the
    device color: a level-synchronous replay of Algorithm 4's budget split
    with the serial ``soar_color``'s tie-breaking (blue iff strictly
    better; first minimizer of each child split), vectorized over every
    node of a level across the batch. ``X`` as produced by
    :func:`gather_batch` (host, float64).
    """
    B, n_max = f.mask.shape
    K = k + 1
    R = np.where(np.isfinite(f.rho_up), f.rho_up, BIG)
    blue = np.zeros((B, n_max), bool)
    budget_at = np.zeros((B, n_max), np.int64)   # budget i for T_v
    ell_at = np.ones((B, n_max), np.int64)       # dist to closest blue anc/d
    budget_at[np.arange(B), f.root] = k
    jj = np.arange(K)[None, :]

    for nd in f.levels:
        valid = nd < n_max                           # real nodes only
        bv, wv = np.nonzero(valid)
        if len(bv) == 0:
            continue
        vv = nd[bv, wv]
        rows = len(vv)
        ar = np.arange(rows)
        i = budget_at[bv, vv]
        ell = ell_at[bv, vv]
        rl = R[bv, vv, ell]
        kids = f.kid[bv, vv]                         # (rows, max_c)
        # partial min-plus chains over children, red (row ell+1) and blue
        # (row 1) variants; sentinel children hit the zero identity slot.
        # The red row only saturates for deepest-level leaves, whose
        # children are all sentinel (zero at every row).
        er = np.minimum(ell + 1, X.shape[2] - 1)
        ch_r = np.empty((rows, f.max_children, K))
        ch_b = np.empty((rows, f.max_children, K))
        ch_r[:, 0] = X[bv, kids[:, 0], er]
        ch_b[:, 0] = X[bv, kids[:, 0], 1]
        for m in range(1, f.max_children):
            ch_r[:, m] = minplus_batch(ch_r[:, m - 1], X[bv, kids[:, m], er])
            ch_b[:, m] = minplus_batch(ch_b[:, m - 1], X[bv, kids[:, m], 1])
        red_val = ch_r[ar, -1, i] + f.load[bv, vv] * rl
        can_blue = f.avail[bv, vv] & (i >= 1)
        blue_val = np.where(
            can_blue,
            ch_b[ar, -1, np.clip(i - 1, 0, K - 1)] + f.send[bv, vv] * rl,
            np.inf)
        isblue = blue_val < red_val                  # strict, as in serial
        blue[bv, vv] = isblue
        budget = i - isblue.astype(np.int64)
        lc = np.where(isblue, 1, ell + 1)
        lcc = np.minimum(lc, X.shape[2] - 1)         # saturates only for
        chain = np.where(isblue[:, None, None], ch_b, ch_r)  # sentinel reads
        # split the budget among children, last child first (mSplit replay)
        for m in range(f.max_children - 1, 0, -1):
            c = kids[:, m]
            real = c < n_max
            Xc = X[bv, c, lcc]                       # (rows, K)
            prev = chain[:, m - 1]
            feas = jj <= budget[:, None]
            vals = prev[ar[:, None], np.clip(budget[:, None] - jj, 0, K - 1)]
            vals = np.where(feas, vals + Xc, np.inf)
            best_j = np.argmin(vals, axis=1)         # first minimizer
            budget_at[bv[real], c[real]] = best_j[real]
            ell_at[bv[real], c[real]] = lc[real]
            budget = budget - np.where(real, best_j, 0)
        c = kids[:, 0]
        real = c < n_max
        budget_at[bv[real], c[real]] = budget[real]
        ell_at[bv[real], c[real]] = lc[real]
    return blue


@dataclasses.dataclass
class BatchResult:
    """Output of :func:`solve_batch` for B padded instances."""

    blue: np.ndarray | None   # (B, n_max) bool, False at padding; None
                              # in costs-only mode (color=False)
    costs: np.ndarray         # (B,) float64, optimal phi per instance
    n: np.ndarray             # (B,) real node counts (mask key for blue)
    bytes_to_host: int = 0    # device->host traffic this solve paid
    tables: np.ndarray | None = None   # node-indexed DP tables; only with
                                       # debug_tables=True

    def blue_of(self, b: int) -> np.ndarray:
        """Unpadded blue mask of instance b."""
        if self.blue is None:
            raise ValueError("solve_batch ran with color=False")
        return self.blue[b, : int(self.n[b])]


def cache_stats() -> dict:
    """Engine cache telemetry.

    ``kernels_built`` counts the CUDA kernel entry points loaded in this
    process (0 until the first solve on a CUDA device); ``forests_built`` /
    ``distinct_layouts`` are the packing-side counts of
    :func:`repro_torch.core.forest.layout_stats`.
    """
    return {"kernels_built": len(built_kernels()), **layout_stats()}


def solve_forest(
    f: Forest,
    k: int,
    *,
    options: EngineOptions | None = None,
    rho_scale: np.ndarray | torch.Tensor | None = None,
    rho_root_add: np.ndarray | torch.Tensor | None = None,
    **engine_kw,
) -> BatchResult:
    """:func:`solve_batch` for a pre-built Forest (amortizes packing).

    Gather and color both run on ``options.device`` and only the
    ``(B, n_max)`` blue masks plus ``(B,)`` costs are transferred back.
    Stray keyword arguments raise ``TypeError``; pass
    ``options=EngineOptions(...)``.

    ``rho_scale``, a ``(B, n_max)`` node-indexed multiplier on each
    instance's *edge* rates, re-solves the prebuilt Forest under effective
    rho ``rho[v] * rho_scale[b, v]`` without repacking: the packed rho-up
    table is rebuilt on the device from the scaled edges. Incompatible with
    ``debug_tables`` (the host replay reads the unscaled tables).

    ``rho_root_add``, a ``(B,)`` *additive* extension of each instance's
    root up-edge rate, applied on top of ``rho_scale`` (which it
    requires): the fleet driver's shared-core transit term.
    """
    opts = resolve_options(options, engine_kw, "solve_forest")
    if k < 0:
        raise ValueError("budget k must be non-negative")
    dev = _device(opts.device)
    if rho_root_add is not None and rho_scale is None:
        raise ValueError("rho_root_add extends a rho_scale re-solve; pass "
                         "rho_scale (ones for a pure additive override)")
    inputs = _device_inputs(f, opts.dtype, dev)
    if rho_scale is not None:
        if opts.debug_tables:
            raise ValueError("rho_scale re-solves on device-side effective "
                             "rho; the debug_tables host replay reads the "
                             "unscaled Forest tables; pick one")
        if tuple(np.shape(rho_scale)) != (f.batch, f.n_max):
            raise ValueError(f"rho_scale shape {tuple(np.shape(rho_scale))} "
                             f"!= {(f.batch, f.n_max)} (node-indexed, padded)")
        base, anc, valid, sn, real = _override_inputs(f, opts.dtype, dev)
        scale = torch.as_tensor(rho_scale, device=dev)
        if rho_root_add is None:
            R = _override_rho(base, anc, valid, sn, real, scale)
        else:
            if tuple(np.shape(rho_root_add)) != (f.batch,):
                raise ValueError(
                    f"rho_root_add shape {tuple(np.shape(rho_root_add))} != "
                    f"({f.batch},) (one root extension per instance)")
            R = _override_rho_add(base, anc, valid, sn, real, scale,
                                  torch.as_tensor(rho_root_add, device=dev),
                                  inputs[8])
        inputs = inputs[:4] + (R,) + inputs[5:]
    blocks = _gather_device(f, k, opts.cap, inputs)
    kid_d, load_d, send_d, avail_d, R, par_d, cidx_d, slot_d, root_d = inputs
    if not opts.color:
        # costs-only planning mode: pull back B scalars, not the tables
        roots = blocks[0][torch.arange(f.batch, device=dev),
                          root_d - f.lvl_off[0], 1, k].cpu().numpy()
        return BatchResult(blue=None, costs=roots.astype(np.float64),
                           n=f.n.copy(), bytes_to_host=int(roots.nbytes))
    if opts.debug_tables:
        Xn = _unpack_tables(f, blocks)
        costs = Xn[np.arange(f.batch), f.root, 1, k]
        return BatchResult(
            blue=color_batch(f, Xn, k), costs=costs, n=f.n.copy(), tables=Xn,
            bytes_to_host=sum(b.numel() * b.element_size() for b in blocks))
    blue_dev, costs_dev = _color_packed(
        blocks, kid_d, par_d, cidx_d, load_d, send_d, avail_d, R,
        root_d, slot_d,
        lvl_off=f.lvl_off, lvl_width=f.lvl_width,
        lvl_internal=f.lvl_internal, lvl_sub=f.lvl_sub, k=k,
        cap=bool(opts.cap))
    blue = blue_dev.cpu().numpy()
    costs = costs_dev.cpu().numpy()
    return BatchResult(blue=blue, costs=costs.astype(np.float64),
                       n=f.n.copy(),
                       bytes_to_host=int(blue.nbytes + costs.nbytes))


def solve_batch(
    trees: Sequence[Tree],
    loads: Sequence[np.ndarray],
    k: int,
    avail: Sequence[np.ndarray] | None = None,
    *,
    options: EngineOptions | None = None,
    **engine_kw,
) -> BatchResult:
    """Solve B phi-BIC instances at once; per-instance output contract of
    :func:`repro_torch.core.soar.soar` (optimal costs, at-most-k masks).

    Instances may be ragged (different n, height, children); the packed
    layout is bucketed (see :func:`repro_torch.core.forest.build_forest`).
    Runs on CUDA unless ``options=EngineOptions(device="cpu")``; see
    :func:`solve_forest`.
    """
    opts = resolve_options(options, engine_kw, "solve_batch")
    return solve_forest(build_forest(trees, loads, avail), k, options=opts)
