"""Per-link traffic and congestion for multi-tenant placements.

SOAR minimizes each tenant's *total* utilization; when T tenants share one
reduction tree their placements can pile messages onto the same links. The
congestion objective (Segal et al. 2022, *Constrained In-network Computing
with Low Congestion in Datacenter Networks*) is the *max-link* traffic:

    congestion(e) = sum_t msg_e^t        (optionally time-weighted by rho_e)

This module is the measurement half of that objective:

  * :func:`messages_up_batch`: host-numpy reference, per-tenant
    ``messages_up`` stacked over the batch;
  * :func:`messages_up_forest`: the batched sweep over the level-packed
    :class:`~repro_torch.core.forest.Forest` layout, bottom-up and level
    synchronous (one gather plus a sum per level, no scatters), on CUDA
    by default. Integer arithmetic throughout, so it equals the host
    reference bitwise in any order;
  * :func:`congestion_profile`, :func:`measure_fleet`,
    :func:`measure_fleet_multi`: per-link totals across tenants, on the
    host.

The penalty loop that *optimizes* the objective lives in
``repro_torch.engine.congestion``; it runs :func:`_messages_body` on the
slot-indexed masks the color leaves on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .forest import Forest
from .reduce import messages_up
from .tree import Tree


def messages_up_batch(trees, loads, blues) -> np.ndarray:
    """Host reference: stacked :func:`~repro_torch.core.reduce.messages_up`.

    ``trees``/``loads``/``blues`` are per-tenant sequences; returns the
    ``(T, n)`` int64 per-edge message counts (edge e = (v, parent(v))).
    """
    return np.stack([messages_up(t, L, U)
                     for t, L, U in zip(trees, loads, blues, strict=True)])


def _messages_body(
    pk_kid: torch.Tensor,     # (B, S, max_c) int64 child slots, sentinel S
    pk_load: torch.Tensor,    # (B, S) int
    pk_send: torch.Tensor,    # (B, S) int
    blue_slot: torch.Tensor,  # (B, S) bool
    *,
    lvl_off: tuple,
    lvl_width: tuple,
    lvl_internal: tuple,
) -> torch.Tensor:
    """Bottom-up level-synchronous message sweep over the packed layout.

    A blue switch emits ``send(v)`` (1 iff its subtree holds load), a red
    switch forwards its own load plus every child's messages. Children
    live one level down, so each level is one gather plus a sum, with a
    zero column appended where sentinel children land; results are
    contiguous level blocks, so their concatenation is slot order.
    Returns the ``(B, S)`` slot-indexed int64 counts on the inputs'
    device.
    """
    B, _, max_c = pk_kid.shape
    dev = pk_kid.device
    msgs_lvl: list = [None] * len(lvl_off)
    for d in range(len(lvl_off) - 1, -1, -1):
        o, W, Wi = lvl_off[d], lvl_width[d], lvl_internal[d]
        if W == 0:                                     # bucketed tail level
            msgs_lvl[d] = torch.zeros((B, 0), dtype=torch.int64, device=dev)
            continue
        acc = pk_load[:, o : o + W].to(torch.int64)
        if Wi > 0:
            o1, W1 = lvl_off[d + 1], lvl_width[d + 1]
            ch = torch.cat([msgs_lvl[d + 1],
                            torch.zeros((B, 1), dtype=torch.int64,
                                        device=dev)], dim=1)
            kidl = torch.clamp(pk_kid[:, o : o + Wi] - o1, max=W1)
            childsum = torch.gather(ch, 1, kidl.reshape(B, Wi * max_c)
                                    ).reshape(B, Wi, max_c).sum(dim=2)
            acc = torch.cat([acc[:, :Wi] + childsum, acc[:, Wi:]], dim=1)
        msgs_lvl[d] = torch.where(blue_slot[:, o : o + W],
                                  pk_send[:, o : o + W].to(torch.int64), acc)
    return torch.cat([m for m in msgs_lvl if m.shape[1]], dim=1)


_MSG_INPUT_CACHE: dict[tuple, tuple] = {}


def _msg_device_inputs(f: Forest, dev: torch.device) -> tuple:
    """One host-to-device upload of the sweep's static arrays per
    (Forest, device): ``pk_kid``, ``pk_load``, ``pk_send``, ``slot_of``.
    Cached like the engine's ``_device_inputs``: built Forests are
    immutable, rebuild instead of mutating one in place."""
    from ..engine.batched import _cached

    def make():
        return tuple(torch.as_tensor(np.ascontiguousarray(a),
                                     dtype=torch.int64, device=dev)
                     for a in (f.pk_kid, f.pk_load, f.pk_send, f.slot_of))
    return _cached(_MSG_INPUT_CACHE, f, torch.int64, dev, make)


def messages_up_forest(f: Forest, blue: np.ndarray, *,
                       options=None) -> np.ndarray:
    """Batched per-edge message counts on the device, node-indexed.

    ``blue``: the ``(B, n_max)`` node-indexed masks exactly as
    :func:`repro_torch.engine.solve_forest` returns them (False at
    padding). Returns ``(B, n_max)`` int64 message counts, zero at padded
    nodes, equal to the host :func:`messages_up_batch` on the real nodes.
    Runs on ``options.device`` (an ``EngineOptions``; CUDA by default).
    The sweep counts in int64, but instances whose total load reaches
    2**31 are rejected as the JAX package's int32 sweep rejects them, so
    both packages accept the same inputs.
    """
    from ..engine.batched import _device
    from ..engine.options import resolve_options
    opts = resolve_options(options, {}, "messages_up_forest")
    B, n_max = f.mask.shape
    if blue.shape != (B, n_max):
        raise ValueError(f"blue shape {blue.shape} != {(B, n_max)}")
    # no edge carries more messages than its instance's total load
    peak = int(f.pk_load.sum(axis=1).max()) if f.pk_load.size else 0
    if peak >= 2 ** 31:
        raise ValueError(f"total load {peak} overflows the device sweep's "
                         "int32 accumulator; use messages_up_batch")
    dev = _device(opts.device)
    # slot-indexed blue: padded slots (slot_node < 0) are never blue
    src = np.where(f.slot_node >= 0, f.slot_node, 0)
    blue_slot = np.take_along_axis(np.asarray(blue, bool), src, axis=1)
    blue_slot &= f.slot_node >= 0
    kid, load, send, slot_of = _msg_device_inputs(f, dev)
    flat = _messages_body(kid, load, send,
                          torch.as_tensor(blue_slot, device=dev),
                          lvl_off=f.lvl_off, lvl_width=f.lvl_width,
                          lvl_internal=f.lvl_internal)
    # back to node indexing: padded nodes' slot_of is n_slots, a zero
    pad = torch.cat([flat, flat.new_zeros((B, 1))], dim=1)
    return torch.gather(pad, 1, slot_of).cpu().numpy()


def congestion_profile(msgs: np.ndarray,
                       rho: np.ndarray | None = None) -> np.ndarray:
    """Per-link congestion across tenants: ``sum_t msg_e^t [* rho_e]``.

    ``msgs``: (T, n) per-tenant message counts on a *shared* tree (so link
    e of every tenant is the same physical link). ``rho`` switches from
    message-count congestion (the default, Segal et al.'s objective) to
    time-weighted congestion (transmission seconds per link).
    """
    c = np.asarray(msgs, np.int64).sum(axis=0)
    return c * np.asarray(rho) if rho is not None else c


class FleetMeasurement(NamedTuple):
    """Congestion measurement of T placements on one shared tree."""

    msgs: np.ndarray            # (T, n) per-tenant per-link message counts
    congestion: np.ndarray      # (n,) per-link totals (count or time)
    max_congestion: float
    mean_congestion: float      # mean over links carrying traffic
    costs: np.ndarray           # (T,) per-tenant utilization on t.rho


def measure_fleet(t: Tree, loads, blues,
                  rho_weighted: bool = False) -> FleetMeasurement:
    """Host-side fleet measurement, the one definition of the reported
    congestion statistics: max over all links, mean over links that carry
    traffic, utilization on the *original* rho."""
    msgs = messages_up_batch([t] * len(loads), loads, blues)
    prof = congestion_profile(msgs, t.rho if rho_weighted else None)
    carrying = prof[prof > 0]
    return FleetMeasurement(
        msgs=msgs, congestion=prof,
        max_congestion=float(prof.max()),
        mean_congestion=float(carrying.mean()) if carrying.size else 0.0,
        costs=(msgs * t.rho).sum(axis=1).astype(np.float64))


def max_congestion(t: Tree, loads, blues,
                   rho_weighted: bool = False) -> float:
    """Convenience: max-link congestion of per-tenant placements on ``t``."""
    return measure_fleet(t, loads, blues, rho_weighted).max_congestion


class MultiFleetMeasurement(NamedTuple):
    """Congestion measurement of T placements across N trees + shared core.

    Link ids follow the fleet's global link-id space: tree g's up-links
    occupy ``[link_off[g], link_off[g] + n_g)`` in ``congestion``, the
    shared-core links fill the final ``C`` entries (also broken out as
    ``core_congestion``). ``msgs`` rows are tree-local (tenant t's counts
    on its own tree, zero-padded to the widest tree); ``costs`` stay
    tree-local utilization on each tree's original rho, the semantics of
    :func:`measure_fleet` for the N=1 fleet.
    """

    msgs: np.ndarray            # (T, max_g n_g) tree-local message counts
    congestion: np.ndarray      # (sum n_g + C,) global per-link profile
    core_congestion: np.ndarray  # (C,)
    max_congestion: float
    mean_congestion: float      # mean over links carrying traffic
    costs: np.ndarray           # (T,) per-tenant utilization on own tree
    link_off: np.ndarray        # (N,) global segment start per tree


def measure_fleet_multi(trees, tree_of, loads, blues, core_rho=None,
                        core_path=None,
                        rho_weighted: bool = False) -> MultiFleetMeasurement:
    """Host-side measurement for a multi-tree fleet sharing a core.

    ``trees``: the N distinct trees; ``tree_of[t]`` names tenant t's tree;
    ``core_rho`` (C,) / ``core_path`` (per tree, core link ids crossed)
    describe the shared core: a tenant's root-crossing messages (the
    count on its root's up-edge) transit every core link on its tree's
    path. Congestion on a core link is the sum of those root counts over
    the tenants crossing it (times ``core_rho`` when ``rho_weighted``).
    For ``N=1, C=0`` this reduces exactly to :func:`measure_fleet`.
    """
    trees = list(trees)
    tid = np.asarray(list(tree_of), np.int64)
    T = tid.size
    crho = (np.zeros(0, np.float64) if core_rho is None
            else np.asarray(core_rho, np.float64))
    C = crho.size
    path = (tuple(() for _ in trees) if core_path is None
            else tuple(tuple(int(c) for c in p) for p in core_path))
    tree_n = np.asarray([t.n for t in trees], np.int64)
    link_off = np.concatenate([[0], np.cumsum(tree_n)[:-1]]).astype(np.int64)
    n_big = int(tree_n.max())
    msgs = np.zeros((T, n_big), np.int64)
    costs = np.zeros(T, np.float64)
    for t in range(T):
        g = int(tid[t])
        tr = trees[g]
        m = messages_up(tr, loads[t], blues[t])
        msgs[t, : tr.n] = m
        costs[t] = (m * tr.rho).sum()
    segs = []
    for g, tr in enumerate(trees):
        rows = msgs[tid == g][:, : tr.n]
        segs.append(congestion_profile(rows,
                                       tr.rho if rho_weighted else None))
    root_msgs = np.asarray(
        [msgs[t, trees[int(tid[t])].root] for t in range(T)], np.int64)
    core = np.zeros(C, np.float64 if rho_weighted else np.int64)
    for c in range(C):
        crossing = np.asarray([c in path[int(tid[t])] for t in range(T)])
        cnt = root_msgs[crossing].sum()
        core[c] = cnt * crho[c] if rho_weighted else cnt
    prof = np.concatenate(segs + [core]) if C else np.concatenate(segs)
    carrying = prof[prof > 0]
    return MultiFleetMeasurement(
        msgs=msgs, congestion=prof, core_congestion=core,
        max_congestion=float(prof.max()),
        mean_congestion=float(carrying.mean()) if carrying.size else 0.0,
        costs=costs, link_off=link_off)
