"""Plain torch oracle for the batched min-plus convolution.

Infeasible split positions carry the finite ``BIG`` sentinel rather than
``inf``. The candidate set differs from the kernels' (they add ``b[j]`` to
a shifted-in ``BIG``), so the two agree exactly wherever the result is
below ``BIG`` and only saturate differently above it.
"""
import torch

from ...core.tropical import BIG


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (rows, K) -> (rows, K); C[r,i] = min_{j<=i} a[r,i-j]+b[r,j]."""
    rows, k = a.shape
    i = torch.arange(k, device=a.device)[:, None]      # output index
    j = torch.arange(k, device=a.device)[None, :]      # split index
    ok = i - j >= 0
    a_shift = a[:, torch.where(ok, i - j, 0)]          # (rows, K, K)
    cand = a_shift + b[:, None, :]
    return torch.where(ok[None], cand, BIG).amin(dim=-1)
