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

``ssm_chunk_scan_bwd_torch`` is the plain backward of the scan, the twin
of the CUDA backward kernel. With ``lambda_t`` the adjoint of ``s_t``
(``gy`` the gradient of y, ``gs_final`` that of the final state) and
``e_t = exp(delta_t * A)``:

    lambda_t = gy_t x C_t + lambda_{t+1} * e_{t+1}   (lambda_T: + gs_final)
    gC_t = sum_d gy_t s_t          gu_t = delta_t sum_n lambda_t B_t
    gB_t = sum_d lambda_t delta_t u_t
    gdelta_t = sum_{d,n} lambda_t (u_t B_t + s_{t-1} e_t A)
    gA = sum_{b,t} lambda_t s_{t-1} e_t delta_t      gs0 = lambda_1 e_1

``ssm_chunk_scan_bwd_seg_torch`` is the same backward in the CUDA
kernels' order: the states rebuilt run by run from the forward's run
checkpoints (``ssm_chunk_scan_torch(..., ck=...)``: the state at the start
of every 32-step run), T cut into segments of ``seg`` steps, each segment
but the first reduced to its carry out from a zero carry in and the
product of its decays, gs_final folded through those last segment first,
each segment walked from its true carry, and gA summed from per (batch
row, segment) partials. The adjoint is linear in its carry, so in exact
arithmetic both orders give the same gradients.
"""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634          # rounded to float32 where it is used
NS = 4                              # states per thread of the kernel
RUN = 32                            # steps between the forward's checkpoints


def scan_lanes(n: int) -> int:
    """Lanes of the kernel per channel: ceil(n / 4) rounded up to a power
    of two (1, 2, 4 or 8 for n <= 32)."""
    return 1 << max(0, math.ceil(n / NS) - 1).bit_length()


def checkpoint_shape(b: int, t: int, d: int, n: int) -> tuple:
    """Shape of the run checkpoints of a (B, T, D, N) scan, the kernel's
    layout: (B, ceil(T / 32), D, 4 x lanes), states past N zero."""
    return (b, -(-t // RUN), d, NS * scan_lanes(n))


def ssm_chunk_scan_torch(u, delta, bv, cv, a, s0, ck=None):
    """u (B, T, D), delta (B, T, 1), bv/cv (B, T, N), a (D, N), s0
    (B, D, N) -> (y (B, T, D), s_final (B, D, N)). ``s0`` is not
    written. With ``ck`` (:func:`checkpoint_shape`), the state at the
    start of every 32-step run is written into it, as the kernel writes
    it."""
    b, t, d = u.shape
    n = bv.shape[-1]
    y = torch.empty((b, t, d), dtype=u.dtype, device=u.device)
    if ck is not None:
        if tuple(ck.shape) != checkpoint_shape(b, t, d, n):
            raise ValueError(f"ck {tuple(ck.shape)}, want "
                             f"{checkpoint_shape(b, t, d, n)}")
        ck[..., n:] = 0
    s = s0
    for i in range(t):
        if ck is not None and i % RUN == 0:
            ck[:, i // RUN, :, :n] = s
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


def ssm_chunk_scan_bwd_torch(u, delta, bv, cv, a, s0, gy, gs_final=None):
    """The scan's backward: the forward's arguments, ``gy`` (B, T, D) and
    the final state's gradient ``gs_final`` (B, D, N; None for zero) ->
    ``(gu, gdelta, gbv, gcv, ga, gs0)``, each of its input's shape, in the
    inputs' dtype. A forward loop keeps every state; a reverse loop over
    t carries the adjoint (module docstring)."""
    b, t, d = u.shape
    states = [s0]
    s = s0
    for i in range(t):
        d_t = delta[:, i]
        s = s * torch.exp(d_t[..., None] * a[None]) + \
            (d_t * u[:, i])[..., None] * bv[:, i, None, :]
        states.append(s)
    gu, gbv, gcv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                    for x in (u, bv, cv))
    gdelta = torch.empty_like(delta, memory_format=torch.contiguous_format)
    ga = torch.zeros_like(a)
    carry = torch.zeros_like(s0) if gs_final is None else gs_final
    for i in reversed(range(t)):
        d_t = delta[:, i]                                      # (B, 1)
        e = torch.exp(d_t[..., None] * a[None])                # (B, D, N)
        lam = gy[:, i, :, None] * cv[:, i, None, :] + carry
        gcv[:, i] = torch.einsum("bd,bdn->bn", gy[:, i], states[i + 1])
        gu[:, i] = d_t * torch.einsum("bdn,bn->bd", lam, bv[:, i])
        gbv[:, i] = torch.einsum("bdn,bd->bn", lam, d_t * u[:, i])
        back = states[i] * e                                   # s_{t-1} e_t
        gdelta[:, i, 0] = (lam * (u[:, i, :, None] * bv[:, i, None, :]
                                  + back * a[None])).sum((1, 2))
        ga += (lam * back * d_t[..., None]).sum(0)
        carry = lam * e
    return gu, gdelta, gbv, gcv, ga, carry


def _seg_carries(summaries, gs):
    """The carry into each segment: ``gs`` (gs_final) for the last, then
    c + P x (the carry into the segment after) down to the first; the
    kernel's walk folds the same terms in the same order."""
    carries = [gs]
    for c, p in reversed(summaries):
        carries.append(c + p * carries[-1])
    return carries[::-1]


def ssm_chunk_scan_bwd_seg_torch(u, delta, bv, cv, a, s0, gy, gs_final=None,
                                 seg: int = RUN, ck=None):
    """The backward in the CUDA kernels' order (module docstring), segments
    of ``seg`` steps (any positive length; the kernel's are whole runs);
    ``ck`` the forward's checkpoints, or None to compute them. Same
    arguments and results as :func:`ssm_chunk_scan_bwd_torch`."""
    b, t, d = u.shape
    n = bv.shape[-1]
    if seg < 1:
        raise ValueError(f"seg must be positive, got {seg}")
    if ck is None:
        ck = torch.empty(checkpoint_shape(b, t, d, n), dtype=u.dtype,
                         device=u.device)
        ssm_chunk_scan_torch(u, delta, bv, cv, a, s0, ck=ck)
    before = []                      # the state before each step
    for i in range(t):
        s = ck[:, i // RUN, :, :n] if i % RUN == 0 else s
        before.append(s)
        d_t = delta[:, i]
        s = s * torch.exp(d_t[..., None] * a[None]) + \
            (d_t * u[:, i])[..., None] * bv[:, i, None, :]
    after = before[1:] + [s]
    decay = lambda i: torch.exp(delta[:, i][..., None] * a[None])
    bounds = [(lo, min(t, lo + seg)) for lo in range(0, t, seg)]
    summaries = []                   # (c, P) of segments 1, 2, ...
    for lo, hi in bounds[1:]:
        c, p = torch.zeros_like(s0), torch.ones_like(s0)
        for i in reversed(range(lo, hi)):
            e = decay(i)
            c = (gy[:, i, :, None] * cv[:, i, None, :] + c) * e
            p = p * e
        summaries.append((c, p))
    gs = torch.zeros_like(s0) if gs_final is None else gs_final
    carries = _seg_carries(summaries, gs)
    gu, gbv, gcv = (torch.empty_like(x, memory_format=torch.contiguous_format)
                    for x in (u, bv, cv))
    gdelta = torch.empty_like(delta, memory_format=torch.contiguous_format)
    ga_parts = []                    # per segment, per batch row
    for (lo, hi), carry in zip(bounds, carries):
        part = torch.zeros_like(s0)
        for i in reversed(range(lo, hi)):
            d_t = delta[:, i]                                  # (B, 1)
            e = decay(i)
            lam = gy[:, i, :, None] * cv[:, i, None, :] + carry
            gcv[:, i] = torch.einsum("bd,bdn->bn", gy[:, i], after[i])
            gu[:, i] = d_t * torch.einsum("bdn,bn->bd", lam, bv[:, i])
            gbv[:, i] = torch.einsum("bdn,bd->bn", lam, d_t * u[:, i])
            back = before[i] * e                               # s_{t-1} e_t
            gdelta[:, i, 0] = (lam * (u[:, i, :, None] * bv[:, i, None, :]
                                      + back * a[None])).sum((1, 2))
            part = part + lam * back * d_t[..., None]
            carry = lam * e
        ga_parts.append(part)
        if lo == 0:
            gs0 = carry
    ga = torch.zeros_like(a)
    for row in range(b):             # the kernel's (batch row, segment)
        for part in ga_parts:        # order
            ga = ga + part[row]
    return gu, gdelta, gbv, gcv, ga, gs0
