"""Launchers of the CUDA selective-SSM scan and its backward
(``csrc/ssm_scan.cu``).

The port's counterpart of the Pallas ``ssm_chunk_scan_pallas``. Its plain
version is :mod:`repro_torch.kernels.ssm_scan.ref`, with which it agrees
to rounding. It takes float32 only, as the model feeds it (the JAX model
casts every operand of the scan to float32). u, delta, bv and cv may be
strided views whose last dimension is contiguous (the model passes u as
half of its input projection and bv, cv as slices of one (B, T, 2N + 1)
projection, with no copy); a and s0 are contiguous. The final state is
written into ``s_out``, which may be ``s0`` itself: each of the kernel's
threads reads its state before it writes it. Counts each launch in
``.launches``.

Given ``ck`` (:func:`scan_checkpoints`), the forward also writes the state
at the start of every 32-step run, which the backward starts from; y and
the final state are the same bits with and without it.

The backward (``ssm_chunk_scan_bwd_cuda``) has no Pallas twin (the JAX
package differentiates a jnp scan); its plain versions are
``ref.ssm_chunk_scan_bwd_torch`` and, in the kernels' order,
``ref.ssm_chunk_scan_bwd_seg_torch``. It takes the forward's operands as
the forward does, gy and gs_final contiguous, and the forward's
checkpoints (without them it first runs the forward kernel to write
them, counted in ``ssm_chunk_scan_cuda.launches``), and returns
contiguous gradients. It rebuilds each run's states from its checkpoint
and cuts T into segments (:func:`bwd_plan`) walked in parallel. A call
puts up to three kernels on the stream (the segments' carries, the walk,
the fixed-order sums) and counts one in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, library, stream_of
from .ref import RUN, checkpoint_shape

MAX_STATE = 32                   # N: one warp's lanes at most


def _strides(name: str, t: torch.Tensor, what: str) -> tuple[int, int]:
    """(batch, time) element strides of a (B, T, X) view with X
    contiguous (a length-1 X has no stride to check)."""
    if t.shape[2] > 1 and t.stride(2) != 1:
        raise ValueError(f"{what}: {name} needs a contiguous last "
                         f"dimension, got strides {t.stride()}")
    return t.stride(0), t.stride(1)


def _checked(what: str, named) -> tuple[int, int, int, int]:
    """(B, T, D, N) after the operands' device, dtype and shape checks;
    ``named`` starts with u, delta, bv, cv."""
    u, bv = named[0][1], named[2][1]
    for name, t in named:
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"{what} needs every operand on one CUDA "
                             f"device, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what} takes float32 only, got {name} "
                            f"{t.dtype}")
    B, T, D = u.shape
    N = bv.shape[-1]
    want = {"delta": (B, T, 1), "bv": (B, T, N), "cv": (B, T, N),
            "a": (D, N), "s0": (B, D, N), "s_out": (B, D, N),
            "gy": (B, T, D), "gs_final": (B, D, N)}
    if any(name == "ck" for name, _ in named):      # not on serving's path
        want["ck"] = checkpoint_shape(B, T, D, N)
    bad = {name: tuple(t.shape) for name, t in named
           if name in want and tuple(t.shape) != want[name]}
    if bad:
        raise ValueError(f"{what}: bad shapes u {tuple(u.shape)} {bad}")
    if min(B, T, D, N) < 1 or N > MAX_STATE or B > 65535:
        raise ValueError(f"{what}: needs B, T, D >= 1, 1 <= N <= "
                         f"{MAX_STATE} and B <= 65535, got {(B, T, D, N)}")
    for name, t in named:
        if name not in ("u", "delta", "bv", "cv") and not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return B, T, D, N


def scan_checkpoints(u, bv) -> torch.Tensor:
    """An empty tensor for the forward's run checkpoints of a scan over u
    (B, T, D) and bv (B, T, N): (B, ceil(T / 32), D, 4 x lanes) float32
    on u's device."""
    B, T, D = u.shape
    return torch.empty(checkpoint_shape(B, T, D, bv.shape[-1]),
                       dtype=torch.float32, device=u.device)


def bwd_plan(u, bv) -> tuple[int, int]:
    """(segments, steps a segment) of the backward's cut of T for u (B, T,
    D) and bv (B, T, N) on u's card: the last segment may be shorter."""
    B, T, D = u.shape
    plan = (ctypes.c_int * 2)()
    with torch.cuda.device(u.device):
        err = library().soar_ssm_scan_bwd_plan(B, T, D, bv.shape[-1], plan)
    check(err, "ssm scan backward plan")
    return plan[0], plan[1] * RUN


def ssm_chunk_scan_bwd_cuda(u, delta, bv, cv, a, s0, gy, gs_final=None,
                            ck=None):
    """The scan's backward on the card: the forward's operands, gy (B, T,
    D), gs_final (B, D, N) or None (zero) and the forward's checkpoints
    ``ck`` (:func:`scan_checkpoints`) or None (the forward kernel writes
    them first), float32 -> (gu, gdelta, gbv, gcv, ga, gs0), contiguous,
    each of its operand's shape. Counts each call in ``.launches``."""
    what = "ssm_chunk_scan_bwd_cuda"
    gy = gy.contiguous()
    named = [("u", u), ("delta", delta), ("bv", bv), ("cv", cv), ("a", a),
             ("s0", s0), ("gy", gy)]
    if gs_final is not None:
        gs_final = gs_final.contiguous()
        named.append(("gs_final", gs_final))
    B, T, D, N = _checked(what, named)
    if ck is None:
        ck = scan_checkpoints(u, bv)
        ssm_chunk_scan_cuda(u, delta, bv, cv, a, s0, ck=ck)
    else:
        _checked(what, named + [("ck", ck)])
    strides = [x for name, t in named[:4] for x in _strides(name, t, what)]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=u.device)
    gu, gdelta, gbv, gcv = new(B, T, D), new(B, T, 1), new(B, T, N), \
        new(B, T, N)
    ga, gs0 = new(D, N), new(B, D, N)
    lib = library()
    with torch.cuda.device(u.device):
        nbytes = lib.soar_ssm_scan_bwd_scratch(B, T, D, N)
        check(int(nbytes < 0), "ssm scan backward scratch")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=u.device)
        err = lib.soar_ssm_scan_bwd(
            u.data_ptr(), delta.data_ptr(), bv.data_ptr(), cv.data_ptr(),
            a.data_ptr(), gy.data_ptr(),
            None if gs_final is None else gs_final.data_ptr(),
            ck.data_ptr(), gu.data_ptr(), gdelta.data_ptr(), gbv.data_ptr(),
            gcv.data_ptr(), ga.data_ptr(), gs0.data_ptr(), scratch.data_ptr(),
            B, T, D, N, *strides, stream_of(u))
    check(err, "ssm scan backward launch")
    ssm_chunk_scan_bwd_cuda.launches += 1
    return gu, gdelta, gbv, gcv, ga, gs0


ssm_chunk_scan_bwd_cuda.launches = 0


def ssm_chunk_scan_cuda(u, delta, bv, cv, a, s0, s_out=None, ck=None):
    """The selective-SSM scan on the card: u (B, T, D), delta (B, T, 1),
    bv/cv (B, T, N), a (D, N), s0 (B, D, N), all float32 -> (y (B, T, D),
    s_final (B, D, N)); ``s_final`` is ``s_out`` when given (``s0``
    allowed); ``ck`` (:func:`scan_checkpoints`), when given, gets the run
    checkpoints. Counts each launch in ``.launches``."""
    what = "ssm_chunk_scan_cuda"
    s_out = torch.empty_like(s0) if s_out is None else s_out
    named = (("u", u), ("delta", delta), ("bv", bv), ("cv", cv), ("a", a),
             ("s0", s0), ("s_out", s_out)) + (() if ck is None
                                              else (("ck", ck),))
    B, T, D, N = _checked(what, named)
    strides = [x for name, t in named[:4] for x in _strides(name, t, what)]
    y = torch.empty((B, T, D), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        err = library().soar_ssm_scan(
            u.data_ptr(), delta.data_ptr(), bv.data_ptr(), cv.data_ptr(),
            a.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            None if ck is None else ck.data_ptr(), B, T, D, N, *strides,
            stream_of(u))
    check(err, "ssm scan launch")
    ssm_chunk_scan_cuda.launches += 1
    return y, s_out


ssm_chunk_scan_cuda.launches = 0
