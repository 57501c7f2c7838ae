"""Selective-SSM scan: shape checks and device dispatch.

A CUDA tensor always launches the kernels; a CPU tensor runs the plain
versions (a counter counts each as its kernel: ``kernels.plain``). There
is no option that sends a CUDA tensor to the plain version. Under
autograd (grad enabled and an input that requires it) the scan is
:class:`SSMScan`, whose backward is the backward kernel on the card and
``ssm_chunk_scan_bwd_torch`` on the CPU; otherwise it is one forward
launch, as in serving.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from ..plain import kernel_call
from .ref import ssm_chunk_scan_bwd_torch, ssm_chunk_scan_torch
from .ssm_scan import (scan_checkpoints, ssm_chunk_scan_bwd_cuda,
                       ssm_chunk_scan_cuda)


def scan_flops(u, bv, backward: bool = False) -> float:
    """The plain versions' dot FLOPs: a step's ``<s_t, C_t>_N`` is 2 B D N
    (y); the backward's three contractions a step (gcv, gu, gbv) 6 B D N.
    On fake tensors (a dry run) the wrappers give them to the counter
    without running the loop over T (``kernels.plain``)."""
    b, t, d = u.shape
    return (6.0 if backward else 2.0) * b * t * d * bv.shape[-1]


class SSMScan(torch.autograd.Function):
    """The scan as an autograd function: (u, delta, bv, cv, a, s0) -> (y,
    s_final), differentiable in all six. On the card the forward also
    writes the state at the start of every 32-step run (one float4 a
    thread a run), saved beside the inputs, and the backward kernel
    rebuilds each run's states from it; on the CPU the plain backward
    recomputes the states from the saved inputs."""

    @staticmethod
    def forward(ctx, u, delta, bv, cv, a, s0):
        ctx.set_materialize_grads(False)
        if u.device.type == "cpu":
            ctx.save_for_backward(u, delta, bv, cv, a, s0, None)
            with kernel_call("ssm_scan", u, delta, bv, cv, a, s0) as done:
                if is_fake(u):
                    return done((torch.empty_like(u), torch.empty_like(s0)),
                                flops=scan_flops(u, bv))
                return done(ssm_chunk_scan_torch(u, delta, bv, cv, a, s0))
        ck = scan_checkpoints(u, bv)
        ctx.save_for_backward(u, delta, bv, cv, a, s0, ck)
        return ssm_chunk_scan_cuda(u, delta, bv, cv, a, s0, ck=ck)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gs):
        u, delta, bv, cv, a, s0, ck = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(u)
        if u.device.type == "cpu":
            with kernel_call("ssm_scan_bwd", u, delta, bv, cv, a, s0, gy,
                             gs) as done:
                if is_fake(u):
                    return done(tuple(map(torch.empty_like, (
                        u, delta, bv, cv, a, s0))), flops=scan_flops(
                            u, bv, backward=True))
                return done(ssm_chunk_scan_bwd_torch(u, delta, bv, cv, a, s0,
                                                     gy, gs))
        return ssm_chunk_scan_bwd_cuda(u, delta, bv, cv, a, s0, gy, gs,
                                       ck=ck)


def ssm_chunk_scan(u, delta, bv, cv, a, s0, s_out=None):
    """Selective-SSM scan: u (B, T, D) float32, delta (B, T, 1), bv/cv
    (B, T, N), a (D, N), s0 (B, D, N) -> (y (B, T, D), s_final (B, D, N)).

    The JAX wrapper runs its Pallas kernel only when T is a multiple of
    ``chunk`` and its reference otherwise; the CUDA kernel takes any T,
    T = 1 (a decode step) included, so there is no ``chunk`` here. With
    ``s_out`` (which may be ``s0`` itself) the final state is written into
    it and it is returned: a decode step updates its cache in place. That
    form is for inference only and raises under autograd."""
    B, T, D = u.shape
    N = bv.shape[-1]
    if delta.shape != (B, T, 1) or bv.shape != (B, T, N) or \
            cv.shape != (B, T, N):
        raise ValueError(f"bad shapes delta={tuple(delta.shape)} "
                         f"bv={tuple(bv.shape)} cv={tuple(cv.shape)}")
    if a.shape != (D, N) or s0.shape != (B, D, N):
        raise ValueError(f"bad shapes a={tuple(a.shape)} "
                         f"s0={tuple(s0.shape)}")
    if s_out is not None and s_out.shape != s0.shape:
        raise ValueError(f"bad shape s_out={tuple(s_out.shape)}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, bv, cv, a, s0)):
        if s_out is not None:
            raise ValueError("ssm_chunk_scan: s_out (the in-place state of "
                             "a decode step) is for inference only, not "
                             "under autograd")
        return SSMScan.apply(u, delta, bv, cv, a, s0)
    if u.device.type == "cpu":
        with kernel_call("ssm_scan", u, delta, bv, cv, a, s0) as done:
            if is_fake(u):
                return done((torch.empty_like(u), torch.empty_like(s0)
                             if s_out is None else s_out),
                            flops=scan_flops(u, bv))
            y, s = ssm_chunk_scan_torch(u, delta, bv, cv, a, s0)
            return done((y, s) if s_out is None else (y, s_out.copy_(s)))
    return ssm_chunk_scan_cuda(u, delta, bv, cv, a, s0, s_out)
