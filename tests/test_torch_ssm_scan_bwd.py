"""The scan's backward in the CUDA kernels' order, on the CPU:
``ref.ssm_chunk_scan_bwd_seg_torch``.

The backward kernels (``csrc/ssm_scan.cu``) rebuild each 32-step run's
states from the forward's run checkpoints, cut T into segments walked in
parallel, fold gs_final through the later segments' (carry out from zero,
product of decays) pairs, last first, and sum gA from per (batch row,
segment) partials. The plain twin takes that order with segments of any
length ``seg``. Held here, on numpy-seeded inputs at the JAX test shapes,
T not a multiple of the run and T = 1, for seg in {1, 7, 32, T}:

* in float64, against the sequential plain backward
  ``ssm_chunk_scan_bwd_torch`` (rtol 1e-10: the same sums in another
  order) and against ``jax.vjp`` of the JAX oracle ``ssm_chunk_scan_ref``
  (rtol 1e-5, each gradient's atol 1e-5 of its largest value, as
  ``tests/test_torch_ssm_train.py`` holds the plain backward);
* in float32, within ``chip_smoke.SCAN_BWD_REL`` of the float64 plain
  backward on the backward on absolute values (``scan_bwd_magnitude``);
  one segment's carry dropped exceeds that limit;
* the plain forward's run checkpoints are the states at the run starts;
  ``SSMScan`` passes gradcheck across a run boundary.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_chunk_scan_ref
from repro_torch.kernels.ssm_scan import ops, ref
from repro_torch.kernels.ssm_scan.ref import (RUN, checkpoint_shape,
                                              ssm_chunk_scan_bwd_seg_torch,
                                              ssm_chunk_scan_bwd_torch,
                                              ssm_chunk_scan_torch)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# the JAX test shapes; T = 1; T not a multiple of the run at 1, 2, 4 and
# 8 lanes a channel
SHAPES = [(1, 16, 8, 4), (2, 32, 16, 4), (3, 64, 24, 8), (2, 32, 16, 32),
          (2, 1, 8, 16), (2, 45, 10, 5), (1, 77, 6, 16), (2, 40, 5, 3)]
NAMES = ("gu", "gdelta", "gbv", "gcv", "ga", "gs0")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, t, d, n):
    """numpy float32 u, delta, bv, cv (slices of one (B, T, 2N + 1) array,
    as the model passes them), a, s0, gy and gs_final."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    delta = np.log1p(np.exp(f(b, t, 1) - 2)).astype(np.float32)
    a = -np.exp(f(d, n) * 0.3).astype(np.float32)
    proj = f(b, t, 2 * n + 1)
    return (f(b, t, d), delta, proj[..., :n], proj[..., n:2 * n], a,
            f(b, d, n), f(b, t, d), f(b, d, n))


def _torch(xs, dtype):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dtype) for x in xs]


def _segs(t):
    return sorted({1, 7, 32, t})


CASES = [(shape, seg) for shape in SHAPES for seg in _segs(shape[1])]


@pytest.mark.parametrize("with_gs", [True, False])
@pytest.mark.parametrize("shape,seg", CASES)
def test_seg_twin_equals_the_sequential_backward_in_float64(shape, seg,
                                                            with_gs):
    xs = _torch(_inputs(sum(shape), *shape), torch.float64)
    gs = xs[7] if with_gs else None
    got = ssm_chunk_scan_bwd_seg_torch(*xs[:7], gs, seg=seg)
    want = ssm_chunk_scan_bwd_torch(*xs[:7], gs)
    for name, g, w, x in zip(NAMES, got, want, xs):
        assert g.shape == x.shape and g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10 * float(
            w.abs().max()), msg=name)


@pytest.mark.parametrize("shape,seg", CASES)
def test_seg_twin_matches_jax_vjp_of_the_reference(shape, seg):
    xs = _inputs(sum(shape) + 1, *shape)
    _, vjp = jax.vjp(ssm_chunk_scan_ref, *map(jnp.asarray, xs[:6]))
    want = vjp((jnp.asarray(xs[6]), jnp.asarray(xs[7])))
    x64 = _torch(xs, torch.float64)
    got = ssm_chunk_scan_bwd_seg_torch(*x64, seg=seg)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def _over(xs, got):
    """err / limit of float32 gradients ``got`` against the float64 plain
    backward (chip_smoke's measure)."""
    x64 = [x.double() for x in xs]
    want = ssm_chunk_scan_bwd_torch(*x64)
    mag = chip_smoke.scan_bwd_magnitude(*xs)
    return chip_smoke.scan_bwd_over(got, want, mag)[1]


@pytest.mark.parametrize("shape,seg", CASES)
def test_seg_twin_in_float32_is_within_the_derived_limit(shape, seg):
    xs = _torch(_inputs(sum(shape) + 2, *shape), torch.float32)
    got = ssm_chunk_scan_bwd_seg_torch(*xs, seg=seg)
    assert all(g.dtype == torch.float32 for g in got)
    assert _over(xs, got) <= 1.0


@pytest.mark.parametrize("shape,seg,drop", [((2, 77, 10, 16), 32, 1),
                                            ((1, 45, 6, 5), 7, 3),
                                            ((2, 64, 8, 4), 1, 40)])
def test_a_dropped_segment_carry_exceeds_the_limit(monkeypatch, shape, seg,
                                                   drop):
    """The planted fault of phase 15a on the twin: segment ``drop`` walked
    from a zero carry in; the twin itself passes on the same inputs."""
    xs = _torch(_inputs(sum(shape) + 3, *shape), torch.float32)
    assert _over(xs, ssm_chunk_scan_bwd_seg_torch(*xs, seg=seg)) <= 1.0
    real = ref._seg_carries

    def dropped(summaries, gs):
        carries = real(summaries, gs)
        carries[drop] = torch.zeros_like(carries[drop])
        return carries

    monkeypatch.setattr(ref, "_seg_carries", dropped)
    assert _over(xs, ssm_chunk_scan_bwd_seg_torch(*xs, seg=seg)) > 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_checkpoints_are_the_run_start_states(shape):
    b, t, d, n = shape
    xs = _torch(_inputs(sum(shape) + 4, *shape), torch.float64)[:6]
    ck = torch.full(checkpoint_shape(b, t, d, n), float("nan"),
                    dtype=torch.float64)
    y, s = ssm_chunk_scan_torch(*xs, ck=ck)
    y2, s2 = ssm_chunk_scan_torch(*xs)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert ck.shape[1] == -(-t // RUN) and ck.shape[3] >= n
    assert not ck[..., n:].any()
    assert torch.equal(ck[:, 0, :, :n], xs[5])
    for k in range(1, ck.shape[1]):
        head = ssm_chunk_scan_torch(*(x[:, :k * RUN] for x in xs[:4]),
                                    *xs[4:])[1]
        assert torch.equal(ck[:, k, :, :n], head), k
    with pytest.raises(ValueError, match="ck"):
        ssm_chunk_scan_torch(*xs, ck=ck[:, :1] if t > RUN else ck[..., :1])


def test_seg_twin_takes_the_forwards_checkpoints():
    """Fed the forward's checkpoints, the twin gives what it gives when it
    writes its own; a run-start state changed in them changes its
    gradients (it rebuilds the states from them)."""
    xs = _torch(_inputs(5, 2, 70, 6, 16), torch.float64)
    ck = torch.empty(checkpoint_shape(2, 70, 6, 16), dtype=torch.float64)
    ssm_chunk_scan_torch(*xs[:6], ck=ck)
    own = ssm_chunk_scan_bwd_seg_torch(*xs, seg=32)
    fed = ssm_chunk_scan_bwd_seg_torch(*xs, seg=32, ck=ck)
    assert all(torch.equal(x, y) for x, y in zip(own, fed))
    ck[:, 1] *= 2
    bad = ssm_chunk_scan_bwd_seg_torch(*xs, seg=32, ck=ck)
    assert not torch.equal(bad[3], own[3])


def test_ssm_scan_function_passes_gradcheck_across_runs():
    """``SSMScan`` on CPU tensors in float64 over 35 steps (past one run),
    all six inputs, bv and cv as strided views, both outputs used."""
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s))
    proj = f(1, 35, 5).requires_grad_()
    u, s0 = f(1, 35, 2).requires_grad_(), f(1, 2, 2).requires_grad_()
    delta = torch.nn.functional.softplus(f(1, 35, 1) - 2).requires_grad_()
    a = (-torch.exp(f(2, 2) * 0.3)).requires_grad_()

    def fn(u, delta, proj, a, s0):
        return ops.SSMScan.apply(u, delta, proj[..., :2], proj[..., 2:4], a,
                                 s0)

    assert torch.autograd.gradcheck(fn, (u, delta, proj, a, s0))
