"""Online multi-workload aggregation-switch allocation (paper Sec. 5.2).

Workloads L_0, L_1, ... arrive online; each is allocated at most k blue
switches before the next arrives. Every switch s has an aggregation capacity
a(s) bounding the number of workloads it can serve; the available set for
workload t is Lambda_t = { s : a_t(s) > 0 }.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from . import baselines
from .reduce import all_red, phi
from .soar_fast import soar_fast
from .tree import Tree


@dataclasses.dataclass
class OnlineResult:
    picks: list[np.ndarray]        # blue mask per workload
    costs: np.ndarray              # phi per workload
    red_costs: np.ndarray          # all-red phi per workload (normalizer)
    residual_capacity: np.ndarray  # a(s) after the full sequence

    @property
    def normalized(self) -> np.ndarray:
        """Cumulative utilization ratio vs all-red after each workload."""
        return np.cumsum(self.costs) / np.cumsum(self.red_costs)


def _strategy_fn(name: str) -> Callable:
    if name == "soar":
        return lambda t, load, k, avail, seed: soar_fast(t, load, k, avail=avail).blue
    fn = baselines.STRATEGIES[name]
    return lambda t, load, k, avail, seed: fn(t, load, k, avail=avail, seed=seed)


def online_allocate(
    t: Tree,
    workloads: Sequence[np.ndarray],
    k: int,
    capacity: int,
    strategy: str = "soar",
    seed: int = 0,
) -> OnlineResult:
    fn = _strategy_fn(strategy)
    a = np.full(t.n, capacity, dtype=np.int64)
    picks, costs, red_costs = [], [], []
    for i, load in enumerate(workloads):
        avail = a > 0
        blue = fn(t, load, k, avail, seed + i)
        blue = blue & avail  # defensive: never exceed capacity
        a[blue] -= 1
        picks.append(blue)
        costs.append(phi(t, load, blue))
        red_costs.append(phi(t, load, all_red(t)))
    return OnlineResult(
        picks=picks,
        costs=np.asarray(costs),
        red_costs=np.asarray(red_costs),
        residual_capacity=a,
    )


def workload_stream(
    t: Tree, n_workloads: int, seed: int = 0
) -> list[np.ndarray]:
    """Paper Sec. 5.2: each workload drawn from uniform or power-law w.p. 1/2."""
    from .tree import sample_load

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_workloads):
        dist = "uniform" if rng.random() < 0.5 else "power-law"
        out.append(sample_load(t, dist, seed=int(rng.integers(2**31))))
    return out
