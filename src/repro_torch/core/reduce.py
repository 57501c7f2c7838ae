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

from .tree import Tree


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
