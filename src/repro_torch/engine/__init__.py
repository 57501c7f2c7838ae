"""Batched multi-tenant SOAR placement engine on PyTorch.

``solve_batch(trees, loads, k, avail)`` solves B phi-BIC instances in one
device-resident level-synchronous sweep: the fused level-fold gather and
the on-device traceback, through the CUDA kernels on a CUDA device (the
default) or their plain torch versions with ``EngineOptions(device="cpu")``.
Only masks and costs leave the device (see ``batched.py``).
``solve_congestion`` / ``solve_fleet`` iterate that solve under
penalty-reweighted link rates to minimize the max-link congestion of
tenants sharing trees (and a shared core), with the loop's state on the
device (see ``congestion.py``).
"""
from .batched import (BatchResult, cache_stats, color_batch, gather_batch,
                      solve_batch, solve_forest)
from .congestion import CongestionResult, solve_congestion, solve_fleet
from .options import EngineOptions

__all__ = ["BatchResult", "CongestionResult", "EngineOptions", "cache_stats",
           "color_batch", "gather_batch", "solve_batch", "solve_congestion",
           "solve_fleet", "solve_forest"]
