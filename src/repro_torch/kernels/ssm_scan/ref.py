"""Plain torch version of the selective-SSM scan.

``ssm_chunk_scan_torch`` is the twin of the JAX oracle
``ssm_chunk_scan_ref``: a sequential loop over t with the state carried
from step to step,

    s_t = s_{t-1} * exp(delta_t * A) + (delta_t * u_t) x B_t
    y_t = <s_t, C_t>_N

in the inputs' dtype (float32 from the model; float64 for a reference).
``ssm_chunk_scan_ex2_torch`` repeats the CUDA kernel's arithmetic
(``csrc/ssm_scan.cu``): the decay as a power of two of ``delta * (a *
log2 e)`` with results below 2^-126 flushed to zero, ``delta * u`` once per
(t, d), one rounding for ``s * decay + w`` (an FMA), and y summed in the
kernel's order (pairs of products within each group of four states, then
halves across the groups). Its 2^x is the CPU's and not the card's
``ex2.approx``, and its FMA rounds through float64, so the two agree
within the error bound derived for the kernel
(``chip_smoke.scan_f64_bound``), not bit for bit.
"""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634          # rounded to float32 where it is used
NS = 4                              # states per thread of the kernel


def scan_lanes(n: int) -> int:
    """Lanes of the kernel per channel: ceil(n / 4) rounded up to a power
    of two (1, 2, 4 or 8 for n <= 32)."""
    return 1 << max(0, math.ceil(n / NS) - 1).bit_length()


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


def ssm_chunk_scan_ex2_torch(u, delta, bv, cv, a, s0):
    """The CUDA kernel's arithmetic on float32 inputs: same arguments and
    results as :func:`ssm_chunk_scan_torch`. States past N are padded with
    zeros to the kernel's 4 x lanes, as the kernel pads them."""
    b, t, d = u.shape
    n = bv.shape[-1]
    lanes = scan_lanes(n)
    pad = NS * lanes - n
    f32 = torch.float32
    wide = lambda x: torch.nn.functional.pad(x, (0, pad))
    a2 = wide(a * torch.tensor(LOG2E, dtype=f32))                # (D, NP)
    bw, cw = wide(bv), wide(cv)
    s = wide(s0)
    y = torch.empty((b, t, d), dtype=f32, device=u.device)
    tiny = 2.0 ** -126
    for i in range(t):
        dt = delta[:, i]                                        # (B, 1)
        du = dt * u[:, i]                                       # (B, D)
        dec = torch.exp2(dt[..., None] * a2[None])              # (B, D, NP)
        dec = torch.where(dec < tiny, torch.zeros_like(dec), dec)
        w = du[..., None] * bw[:, i, None, :]
        # the FMA: the product is exact in float64, and the two roundings
        # of the sum differ from one only at rare float32 midpoints
        s = (s.double() * dec.double() + w.double()).to(f32)
        q = (s * cw[:, i, None, :]).view(b, d, lanes, NS)
        p = (q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])   # (B, D, L)
        while p.shape[-1] > 1:
            h = p.shape[-1] // 2
            p = p[..., :h] + p[..., h:]
        y[:, i] = p[..., 0]
    return y, s[..., :n].contiguous()
