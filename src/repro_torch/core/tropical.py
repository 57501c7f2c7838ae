"""Tropical (min-plus) convolution — the SOAR-Gather budget-split primitive.

The mCost inner loop of Algorithm 3 (lines 30-34) is, for every (node, ell)
pair, the min-plus convolution of two monotone budget vectors:

    C[r, i] = min_{0 <= j <= i}  A[r, i-j] + B[r, j]

This module is the numpy reference used by the faithful serial DP
(``soar.py``) and the host color replay of the batched engine.
The device counterparts live in ``repro_torch.kernels.minplus`` (the CUDA
kernels and their plain torch versions); all of them implement this exact
contract.
"""
from __future__ import annotations

import numpy as np

#: Finite +inf stand-in shared by every device min-plus path (the CUDA
#: kernels and their plain torch versions). Padded/invalid slots must hold
#: a *finite* sentinel so that ``0 * pad`` stays finite (``0 * inf`` is NaN
#: and would poison the min reductions); 1e18 is far above any reachable
#: utilization, and every path rounds it to the same float32 value. Host float64 references keep using ``np.inf`` —
#: they never multiply a pad by zero.
BIG = 1e18


def minplus(A: np.ndarray, B: np.ndarray, out_w: int | None = None) -> np.ndarray:
    """Row-wise min-plus convolution. A: (L, Wa), B: (L, Wb) -> (L, out_w).

    Y[l, i] = min_{0<=j<=i} A[l, i-j] + B[l, j].

    With monotone (at-most-budget) operands, truncating to ``out_w``
    columns is exact — the subtree-budget cap optimization.
    """
    A = np.atleast_2d(A)
    B = np.atleast_2d(B)
    L, Wa = A.shape
    Wb = B.shape[1]
    W = (Wa + Wb - 1) if out_w is None else min(out_w, Wa + Wb - 1)
    Y = np.full((L, W), np.inf)
    for j in range(min(Wb, W)):
        seg = min(Wa, W - j)
        np.minimum(Y[:, j : j + seg], A[:, :seg] + B[:, j : j + 1],
                   out=Y[:, j : j + seg])
    return Y


def minplus_batch(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Batched square min-plus convolution: (B, K) x (B, K) -> (B, K).

    Same recurrence as :func:`minplus` restricted to equal operand widths
    and output truncated to K (the at-most-k budget table width).
    """
    Bn, K = A.shape
    Y = np.full((Bn, K), np.inf)
    for j in range(K):
        np.minimum(Y[:, j:], A[:, : K - j] + B[:, j : j + 1], out=Y[:, j:])
    return Y
