"""The scan kernel's arithmetic on the CPU: ``ref.ssm_chunk_scan_ex2_torch``.

The CUDA scan (``csrc/ssm_scan.cu``) computes the decay as ex2.approx of a
pre-scaled argument, ``delta * u`` once per (t, d), the state update as one
FMA, and y in its own order (pairs within each thread's four states, then
a reduce-scatter over the lanes of a channel). Its plain twin repeats that
arithmetic (with the CPU's 2^x) and is held, on numpy-seeded inputs,
against the JAX package's oracle and Pallas kernel (interpret mode) at the
JAX test's rtol = atol = 1e-5, and against the float64 plain version within
the running error bound derived for the kernel
(``chip_smoke.scan_f64_bound``). Both of chip_smoke's planted faults (the
carry dropped at one step; lane 0 left out of y) must exceed that bound.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_chunk_scan as j_scan
from repro.kernels.ssm_scan.ref import ssm_chunk_scan_ref
from repro_torch.kernels.ssm_scan.ref import (scan_lanes,
                                              ssm_chunk_scan_ex2_torch,
                                              ssm_chunk_scan_torch)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

JAX_SHAPES = [(1, 16, 8, 4, 8), (2, 32, 16, 4, 8), (3, 64, 24, 8, 16),
              (2, 32, 16, 4, 32)]
# (B, T, D, N): every lane count of the kernel (N 1 and 3 -> 1 lane, 5 ->
# 2, 16 -> 4, 32 -> 8), T = 1 and T not a multiple of the kernel's run
MORE_SHAPES = [(2, 1, 12, 1), (1, 37, 9, 3), (2, 40, 10, 5), (2, 1, 40, 16),
               (1, 45, 20, 16), (1, 33, 6, 32)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, t, d, n):
    """numpy u, delta, bv, cv, a, s0 as the JAX test draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    delta = np.log1p(np.exp(f(b, t, 1) - 2)).astype(np.float32)
    a = -np.exp(f(d, n) * 0.3).astype(np.float32)
    return f(b, t, d), delta, f(b, t, n), f(b, t, n), a, f(b, d, n)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5, err_msg=err_msg)


@pytest.mark.parametrize("n,lanes", [(1, 1), (3, 1), (4, 1), (5, 2), (8, 2),
                                     (9, 4), (16, 4), (17, 8), (32, 8)])
def test_scan_lanes_match_the_kernel_dispatch(n, lanes):
    """``soar_ssm_scan`` takes 1 lane for N <= 4, 2 for N <= 8, 4 for
    N <= 16 and 8 up to 32."""
    assert scan_lanes(n) == lanes


@pytest.mark.parametrize("b,t,d,n,chunk", JAX_SHAPES)
def test_ex2_twin_matches_jax_ref_and_pallas(b, t, d, n, chunk):
    xs = _inputs(b * 100 + t, b, t, d, n)
    y, s = ssm_chunk_scan_ex2_torch(*map(torch.from_numpy, xs))
    jy, js = ssm_chunk_scan_ref(*map(jnp.asarray, xs))
    _close(y, jy, "y vs ref")
    _close(s, js, "state vs ref")
    py, ps = j_scan(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    _close(y, py, "y vs Pallas")
    _close(s, ps, "state vs Pallas")


@pytest.mark.parametrize("b,t,d,n", MORE_SHAPES)
def test_ex2_twin_matches_jax_ref_at_every_lane_count(b, t, d, n):
    xs = _inputs(7 * t + n, b, t, d, n)
    y, s = ssm_chunk_scan_ex2_torch(*map(torch.from_numpy, xs))
    jy, js = ssm_chunk_scan_ref(*map(jnp.asarray, xs))
    _close(y, jy, "y vs ref")
    _close(s, js, "state vs ref")


@pytest.mark.parametrize("b,t,d,n", [s[:4] for s in JAX_SHAPES]
                         + MORE_SHAPES)
def test_ex2_twin_within_the_derived_bound(b, t, d, n):
    """Elementwise within ``scan_f64_bound``'s limit around the float64
    plain version (the PTX ISA's ex2 error; the CPU's 2^x is within it)."""
    xs = tuple(map(torch.from_numpy, _inputs(3 * t + d, b, t, d, n)))
    y, s = ssm_chunk_scan_ex2_torch(*xs)
    y64, s64, ylim, slim, _ = chip_smoke.scan_f64_bound(*xs, keep_from=0)
    _, ry, oky = chip_smoke._over(y, y64, ylim)
    _, rs, oks = chip_smoke._over(s, s64, slim)
    assert oky and oks, (ry, rs)


def test_planted_faults_exceed_the_derived_bound():
    """chip_smoke's two planted faults at a reduced cell (T 300 with the
    faults in the last 64 steps, D 40, N 16): the kernel's twin within the
    limit, each fault beyond it."""
    b, t, d, n = 2, 300, 40, 16
    xs = tuple(map(torch.from_numpy, _inputs(300, b, t, d, n)))
    t0 = t - 64
    y64, _, ylim, _, kept = chip_smoke.scan_f64_bound(*xs, keep_from=t0)
    y, _ = ssm_chunk_scan_ex2_torch(*xs)
    assert chip_smoke._over(y, y64, ylim)[2]
    faults = chip_smoke.scan_faults(xs, y64, ylim, kept, t0)
    assert len(faults) == 2
    for label, (ratio, ok) in faults.items():
        assert not ok and ratio > 1, label


def test_ex2_twin_flushes_tiny_decays_and_pads_states():
    """A decay below 2^-126 flushes to zero, so the state keeps only w;
    with N = 3 the padded fourth state never reaches y."""
    u = torch.ones((1, 1, 2))
    delta = torch.full((1, 1, 1), 200.0)
    a = torch.full((2, 3), -1.0)                 # 2^(-200 log2 e) flushes
    bv, cv = torch.ones((1, 1, 3)), torch.ones((1, 1, 3))
    s0 = torch.full((1, 2, 3), 5.0)
    y, s = ssm_chunk_scan_ex2_torch(u, delta, bv, cv, a, s0)
    assert torch.equal(s, torch.full((1, 2, 3), 200.0))
    assert torch.equal(y, torch.full((1, 1, 2), 600.0))
    wy, ws = ssm_chunk_scan_torch(u, delta, bv, cv, a, s0)
    torch.testing.assert_close(y, wy)
    torch.testing.assert_close(s, ws)
