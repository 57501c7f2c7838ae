"""Byte-complexity models for the WC and PS use cases (paper Sec. 5.3).

The utilization complexity counts *messages*; the byte complexity weighs each
message by its size, which grows under aggregation for non-fixed-size
functions (word-count dictionaries) and stays near-constant for others
(dropout-sparsified gradients).

Message-size model: a message aggregated over a set S of servers has expected
size ``size_fn(|S|)`` — the expected number of distinct keys in the union of
the servers' key sets:

* WC: each server holds ``words_per_server`` iid Zipf(s) draws over a
  ``vocab``-word corpus; E[distinct | T draws] = sum_w 1 - (1 - p_w)^T.
  Calibrated to the paper's dump: 54M total words, 800K unique.
* PS: gradient over ``features`` dims with dropout rate q: a server holds each
  key w.p. (1-q); union over s servers has features * (1 - q^s) keys.

A red switch forwards messages unchanged; a blue switch merges everything
below it into one message whose size is size_fn(#servers below). The byte
complexity weighs bytes by rho(e) (equal to plain byte counts at unit rates,
which is the paper's Fig. 8 setting).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .tree import Tree


# ---------------------------------------------------------------------------
# Use-case message-size functions
# ---------------------------------------------------------------------------

class WordCountModel:
    """Zipf corpus expected-distinct-count size function (WC use case)."""

    def __init__(
        self,
        total_words: int = 54_000_000,
        vocab: int = 800_000,
        zipf_s: float = 1.07,
        n_servers: int = 640,
        bytes_per_kv: int = 12,  # word hash + count
    ):
        self.words_per_server = total_words / n_servers
        self.bytes_per_kv = bytes_per_kv
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** (-zipf_s)
        self._log1mp = np.log1p(-(p / p.sum()))
        self._cache: dict[int, float] = {}

    def size(self, n_servers_in_msg: int) -> float:
        """Expected bytes of a message aggregated over n servers."""
        n = int(n_servers_in_msg)
        if n not in self._cache:
            draws = self.words_per_server * n
            distinct = float((1.0 - np.exp(self._log1mp * draws)).sum())
            self._cache[n] = distinct * self.bytes_per_kv
        return self._cache[n]


class ParameterServerModel:
    """Dropout-sparsified gradient size function (PS use case)."""

    def __init__(
        self,
        features: int = 10_000,
        dropout: float = 0.5,
        bytes_per_kv: int = 8,  # index + value
    ):
        self.features = features
        self.keep = 1.0 - dropout
        self.bytes_per_kv = bytes_per_kv

    def size(self, n_servers_in_msg: int) -> float:
        n = int(n_servers_in_msg)
        miss = (1.0 - self.keep) ** n
        return self.features * (1.0 - miss) * self.bytes_per_kv


# ---------------------------------------------------------------------------
# Byte-complexity simulator
# ---------------------------------------------------------------------------

def byte_complexity(
    t: Tree,
    load: np.ndarray,
    blue: np.ndarray,
    size_fn: Callable[[int], float],
    weight_by_rho: bool = True,
) -> float:
    """Total bytes (optionally x rho) sent over all links during Reduce.

    Tracks, per upward edge, a multiset of messages keyed by the number of
    servers already aggregated into each message (sizes only depend on that).
    """
    load = np.asarray(load, dtype=np.int64)
    blue = np.asarray(blue, dtype=bool)
    sub_servers = t.subtree_loads(load)
    # outgoing[v]: dict {servers_in_message: count}
    outgoing: list[dict[int, int] | None] = [None] * t.n
    total = 0.0
    for v in t.topo[::-1]:
        if blue[v]:
            msgs = {int(sub_servers[v]): 1} if sub_servers[v] > 0 else {}
        else:
            msgs = {}
            if load[v] > 0:
                msgs[1] = int(load[v])
            for c in t.children[v]:
                for sc, cnt in outgoing[c].items():  # type: ignore[union-attr]
                    msgs[sc] = msgs.get(sc, 0) + cnt
        outgoing[v] = msgs
        w = float(t.rho[v]) if weight_by_rho else 1.0
        total += w * sum(size_fn(sc) * cnt for sc, cnt in msgs.items())
    return total
