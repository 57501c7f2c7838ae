"""Plain torch version of the selective-SSM scan.

``ssm_chunk_scan_torch`` is the twin of the JAX oracle
``ssm_chunk_scan_ref``: a sequential loop over t with the state carried
from step to step,

    s_t = s_{t-1} * exp(delta_t * A) + (delta_t * u_t) x B_t
    y_t = <s_t, C_t>_N

in the inputs' dtype (float32 from the model; float64 for a reference).
The CUDA kernel ``csrc/ssm_scan.cu`` agrees with it to rounding: it runs
the same products unfused and sums over N in another order.
"""
from __future__ import annotations

import torch


def ssm_chunk_scan_torch(u, delta, bv, cv, a, s0):
    """u (B, T, D), delta (B, T, 1), bv/cv (B, T, N), a (D, N), s0
    (B, D, N) -> (y (B, T, D), s_final (B, D, N)). ``s0`` is not
    written."""
    b, t, d = u.shape
    y = torch.empty((b, t, d), dtype=u.dtype, device=u.device)
    s = s0
    for i in range(t):
        d_t = delta[:, i]                                    # (B, 1)
        decay = torch.exp(d_t[..., None] * a[None])          # (B, D, N)
        s = s * decay + (d_t * u[:, i])[..., None] * bv[:, i, None, :]
        y[:, i] = torch.einsum("bdn,bn->bd", s, cv[:, i])
    return y, s
