"""The port's plain min-plus functions vs the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages, float32. Every comparison
is bitwise (tolerance 0): both sides round each add and product once, in
the same order, and min is exact. Inputs mix in the ``BIG`` sentinel,
which saturates (BIG + BIG = 2e18) and so checks that the candidate sets
are the same, not just the real-valued results.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import levelfold as jlf
from repro.kernels.minplus.ops import minplus as j_ops_minplus
from repro.kernels.minplus.ref import minplus_ref as j_minplus_ref
from repro_torch.core.tropical import BIG
from repro_torch.kernels.minplus import levelfold as tlf
from repro_torch.kernels.minplus.minplus import minplus_cuda
from repro_torch.kernels.minplus.ops import minplus as t_ops_minplus
from repro_torch.kernels.minplus.ref import minplus_ref as t_minplus_ref


def _rows(rng, shape, big_frac=0.2):
    """Dyadic values (multiples of 1/8) with BIG mixed in."""
    x = (rng.integers(0, 400, size=shape) / 8.0).astype(np.float32)
    x[rng.random(shape) < big_frac] = BIG
    return x


def _eq(t: torch.Tensor, j) -> None:
    want = np.asarray(j)
    got = t.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rows,k", [(1, 1), (3, 2), (9, 7), (40, 17),
                                    (5, 40)])
def test_minplus_fused_and_ref_bitwise(rows, k):
    rng = np.random.default_rng(rows * 31 + k)
    a, b = _rows(rng, (rows, k)), _rows(rng, (rows, k))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    want = jax.jit(jlf.minplus_fused)(ja, jb)
    _eq(tlf.minplus_fused(ta, tb), want)
    _eq(t_ops_minplus(ta, tb), want)
    _eq(t_minplus_ref(ta, tb), j_minplus_ref(ja, jb))


@pytest.mark.parametrize("max_c,rows,k", [(1, 4, 3), (2, 6, 5), (5, 8, 9)])
def test_chain_fold_collect_bitwise(max_c, rows, k):
    rng = np.random.default_rng(max_c * 7 + k)
    st = _rows(rng, (max_c, rows, k), big_frac=0.1)
    t_last, t_parts = tlf.chain_fold(torch.from_numpy(st), collect=True)
    j_last, j_parts = jlf.chain_fold(jnp.asarray(st), collect=True)
    _eq(t_last, j_last)
    _eq(t_parts, j_parts)
    _eq(tlf.chain_fold(torch.from_numpy(st)), j_last)


def test_rho_up_and_scaled_edges_bitwise():
    rng = np.random.default_rng(5)
    B, S, H2 = 3, 11, 6
    rho = (rng.integers(1, 64, size=(B, S)) / 16.0).astype(np.float32)
    anc = rng.integers(0, S, size=(B, S, H2 - 1))
    valid = rng.random((B, S, H2)) < 0.7
    scale = (rng.integers(1, 9, size=(B, S)) / 4.0).astype(np.float32)
    extra = (rng.integers(0, 9, size=B) / 8.0).astype(np.float32)
    root = rng.integers(0, S, size=B)
    _eq(tlf.rho_up_from_edges(torch.from_numpy(rho), torch.from_numpy(anc),
                              torch.from_numpy(valid)),
        jlf.rho_up_from_edges(jnp.asarray(rho), jnp.asarray(anc, jnp.int32),
                              jnp.asarray(valid)))
    _eq(tlf.scaled_edges(torch.from_numpy(rho), torch.from_numpy(scale)),
        jlf.scaled_edges(jnp.asarray(rho), jnp.asarray(scale)))
    _eq(tlf.scaled_edges(torch.from_numpy(rho), torch.from_numpy(scale),
                         torch.from_numpy(extra), torch.from_numpy(root)),
        jlf.scaled_edges(jnp.asarray(rho), jnp.asarray(scale),
                         jnp.asarray(extra), jnp.asarray(root, jnp.int32)))


def _level_inputs(rng, B, C, W, max_c, nl, kcap):
    """One level's fold inputs shaped as the engine builds them: the
    child block with its all-zeros identity at C-1, kid in [0, C-1]."""
    xs = _rows(rng, (B, C, nl, kcap), big_frac=0.05)
    xb = _rows(rng, (B, C, kcap), big_frac=0.05)
    xs[:, -1] = 0.0
    xb[:, -1] = 0.0
    kid = rng.integers(0, C, size=(B, W, max_c))
    kid[rng.random((B, W, max_c)) < 0.3] = C - 1
    load = rng.integers(0, 30, size=(B, W)).astype(np.float32)
    send = rng.integers(0, 2, size=(B, W)).astype(np.float32)
    avail = rng.random((B, W)) < 0.7
    rho = (rng.integers(1, 32, size=(B, W, nl)) / 8.0).astype(np.float32)
    pad = rng.random((B, W)) < 0.2            # padded slots: BIG rho, 0 load
    rho[pad] = BIG
    load[pad] = 0.0
    send[pad] = 0.0
    return xs, xb, kid, load, send, avail, rho


@pytest.mark.parametrize("B,C,W,max_c,nl,kcap", [
    (1, 2, 1, 1, 2, 1), (2, 5, 3, 2, 3, 4), (3, 9, 6, 4, 5, 9),
    (2, 17, 8, 8, 13, 33)])
def test_level_fold_matches_level_fold_jnp(B, C, W, max_c, nl, kcap):
    rng = np.random.default_rng(B * 100 + C * 10 + max_c)
    args = _level_inputs(rng, B, C, W, max_c, nl, kcap)
    got = tlf.level_fold(*(torch.from_numpy(a) for a in args),
                         nl=nl, kcap=kcap)
    j = [jnp.asarray(a) for a in args]
    j[2] = j[2].astype(jnp.int32)
    _eq(got, jlf.level_fold_jnp(*j, nl=nl, kcap=kcap))


def test_plain_versions_match_pallas_interpret():
    """The Pallas bodies (interpret mode, as the JAX package's own tests run
    them on the CPU) agree with the port's plain versions bitwise."""
    rng = np.random.default_rng(9)
    a, b = _rows(rng, (6, 5)), _rows(rng, (6, 5))
    _eq(t_ops_minplus(torch.from_numpy(a), torch.from_numpy(b)),
        j_ops_minplus(jnp.asarray(a), jnp.asarray(b), interpret=True))
    args = _level_inputs(rng, 2, 4, 3, 2, 2, 3)
    got = tlf.level_fold(*(torch.from_numpy(x) for x in args), nl=2, kcap=3)
    j = [jnp.asarray(x) for x in args]
    j[2] = j[2].astype(jnp.int32)
    _eq(got, jlf.level_fold_pallas(*j, nl=2, kcap=3, interpret=True))


def test_kernel_wrappers_reject_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the
    host (the dispatchers own the CPU path)."""
    a = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        minplus_cuda(a, a)
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(x) for x in _level_inputs(rng, 1, 3, 2, 2, 2, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        tlf.level_fold_cuda(*args, nl=2, kcap=3)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ops_minplus(a, torch.zeros((2, 4)))
