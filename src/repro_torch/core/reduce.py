"""Reduce-operation simulator (paper Algorithm 1) and utilization cost phi.

Message semantics:
  * a red (non-aggregating) switch forwards every message arriving from its
    children plus L(v) messages of its own servers;
  * a blue (aggregating) switch collapses everything into a single outgoing
    message — but only if its subtree holds any load at all ("the operation
    ends when the destination receives the information from all nodes that
    have strictly positive load"): a zero-load subtree sends nothing.
"""
from __future__ import annotations

import numpy as np

from .tree import DEST, Tree


def messages_up(t: Tree, load: np.ndarray, blue: np.ndarray) -> np.ndarray:
    """msg_e for the upward edge of every switch v (e = (v, p(v)))."""
    load = np.asarray(load, dtype=np.int64)
    blue = np.asarray(blue, dtype=bool)
    sub_load = t.subtree_loads(load)
    msgs = np.zeros(t.n, dtype=np.int64)
    for v in t.topo[::-1]:  # leaves first
        if blue[v]:
            msgs[v] = 1 if sub_load[v] > 0 else 0
        else:
            acc = int(load[v])
            for c in t.children[v]:
                acc += int(msgs[c])
            msgs[v] = acc
    return msgs


def phi(t: Tree, load: np.ndarray, blue: np.ndarray) -> float:
    """Utilization complexity phi(T, L, U) = sum_e msg_e * rho(e) (Eq. 1)."""
    return float((messages_up(t, load, blue) * t.rho).sum())


def agg_width(total: int, scale: float) -> int:
    """Messages a blue switch at capacity scale ``scale`` folds itself.

    A switch whose aggregation plane runs at a fraction ``scale`` of its
    nominal capacity (P4COM-style partial memory/compute loss) folds only
    the *first* ``ceil(total * scale)`` of its ``total`` incoming messages
    — never fewer than one, so it always emits a partial sum — and spills
    the rest raw to its parent. ``scale >= 1`` is the pristine plane
    (everything folds); the ``scale -> 0`` limit folds a single message,
    i.e. the switch degenerates to a forwarder plus a no-op partial.
    """
    total = int(total)
    if total <= 1 or scale >= 1.0:
        return total
    return max(1, int(np.ceil(total * float(scale))))


def messages_up_degraded(t: Tree, load: np.ndarray, blue: np.ndarray,
                         cap_scale: np.ndarray | None = None) -> np.ndarray:
    """Per-edge message counts when blue switches run at reduced capacity.

    ``cap_scale[v]`` is switch v's remaining aggregation-capacity fraction
    (``None`` = all pristine, in which case this is exactly
    :func:`messages_up`). A degraded blue switch with ``w`` incoming
    messages folds ``m = agg_width(w, cap_scale[v])`` of them and sends
    the ``o = w - m`` overflow raw on its own up-edge (``1 + o`` messages
    instead of 1); the overflow is completed at the parent's host, so
    every edge *above* the degraded switch carries its fault-free count.
    """
    msgs = messages_up(t, load, blue)
    if cap_scale is None:
        return msgs
    scale = np.asarray(cap_scale, np.float64)
    if scale.shape != (t.n,):
        raise ValueError(f"cap_scale shape {scale.shape} != ({t.n},)")
    load = np.asarray(load, dtype=np.int64)
    blue = np.asarray(blue, dtype=bool)
    sub_load = t.subtree_loads(load)
    out = msgs.copy()
    for v in range(t.n):
        if blue[v] and sub_load[v] > 0 and scale[v] < 1.0:
            w = int(load[v]) + sum(int(msgs[c]) for c in t.children[v])
            if w > 1:
                out[v] = msgs[v] + (w - agg_width(w, float(scale[v])))
    return out


def phi_degraded(t: Tree, load: np.ndarray, blue: np.ndarray,
                 cap_scale: np.ndarray | None = None) -> float:
    """Utilization of a placement executed at reduced switch capacity:
    phi plus the overflow traffic each degraded blue switch spills one
    hop up. Equals :func:`phi` when ``cap_scale`` is ``None``/all-ones."""
    return float((messages_up_degraded(t, load, blue, cap_scale)
                  * t.rho).sum())


def phi_barrier(t: Tree, load: np.ndarray, blue: np.ndarray) -> float:
    """Alternative characterization via closest blue ancestors (Lemma 4.2).

    phi = sum_{v in U} send(v) * rho(v, p*_v) + sum_{v not in U} L(v) * rho(v, p*_v)

    (send(v) = 1 iff subtree load > 0; equals the paper's ``1`` whenever all
    loads are positive). Used as a cross-check oracle in tests.
    """
    load = np.asarray(load, dtype=np.int64)
    blue = np.asarray(blue, dtype=bool)
    sub_load = t.subtree_loads(load)
    total = 0.0
    for v in range(t.n):
        # distance/time to closest blue ancestor or d
        u = int(t.parent[v])
        acc = float(t.rho[v])
        while u != DEST and not blue[u]:
            acc += float(t.rho[u])
            u = int(t.parent[u])
        if blue[v]:
            total += (1 if sub_load[v] > 0 else 0) * acc
        else:
            total += int(load[v]) * acc
    return total


def all_red(t: Tree) -> np.ndarray:
    return np.zeros(t.n, dtype=bool)


def all_blue(t: Tree) -> np.ndarray:
    return np.ones(t.n, dtype=bool)


def mask_from_set(t: Tree, U) -> np.ndarray:
    m = np.zeros(t.n, dtype=bool)
    for v in U:
        m[int(v)] = True
    return m
