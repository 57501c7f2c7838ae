"""The port's top-k compression on the CPU vs the JAX package's.

The same numpy-seeded rows go through ``repro.kernels.topk_compress``
(the oracle ``topk_compress_ref``, ``lax.top_k`` on |x| in float32; the
Pallas body cannot run on the installed JAX, ROADMAP C1) and through
``repro_torch.kernels.topk_compress`` on CPU tensors, which take the plain
version. Values, indices and thresholds must be equal bit for bit, on
random rows at the JAX test shapes and on rows of ties, zeros, ±0, ±inf,
NaN and fewer than k nonzeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_compress.ops import decompress as j_decompress
from repro.kernels.topk_compress.ops import topk_compress as j_topk
from repro.kernels.topk_compress.ref import topk_compress_ref
from repro_torch.kernels.topk_compress.ops import (decompress, topk_compress,
                                                   topk_threshold)
from repro_torch.kernels.topk_compress.topk_compress import (
    topk_compress_cuda, topk_threshold_cuda)

SHAPES = [(1, 16, 4), (8, 256, 32), (5, 100, 10)]    # tests/test_kernels.py
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    """The same bits in both packages (JAX rounds to ``dtype`` first)."""
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x, jdt)
    a = np.array(jx)
    if dtype == "bfloat16":
        return jx, torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return jx, torch.from_numpy(a)


def _bits(a) -> np.ndarray:
    """Raw bits, so NaN, -0 and bfloat16 compare exactly."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        if a.dtype == torch.float32:
            return a.view(torch.int32).numpy()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _check(x: np.ndarray, k: int, dtype: str):
    jx, tx = _both(x, dtype)
    jv, ji = topk_compress_ref(jx, k)
    tv, ti = topk_compress(tx, k)
    assert tv.dtype == tx.dtype and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    # the threshold _topk_leaf takes: lax.top_k(|x|, k)[0][-1] per row;
    # NaN compared as NaN (the port's plain version keeps the NaN's payload
    # and sign as |x| does, the kernel canonicalizes it)
    want = np.asarray(jax.lax.top_k(jnp.abs(jx.astype(jnp.float32)), k)[0]
                      )[:, -1]
    got = topk_threshold(tx, k).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))
    # every row's indices are distinct
    assert all(len(set(r)) == k for r in ti.tolist())
    return tv, ti


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("r,d,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_topk_equals_ref_bitwise(r, d, k, dtype):
    rng = np.random.default_rng(r * 1000 + d)
    _check(rng.standard_normal((r, d)), k, dtype)


def _special_rows(d: int, rng) -> np.ndarray:
    ties = rng.integers(-3, 4, size=d).astype(np.float64)
    zeros = np.zeros(d)
    signed_zero = np.where(rng.random(d) < 0.5, -0.0, 0.0)
    infs = rng.standard_normal(d)
    infs[rng.choice(d, 5, replace=False)] = np.inf
    infs[rng.choice(d, 5, replace=False)] = -np.inf
    nans = rng.standard_normal(d)
    nans[rng.choice(d, 3, replace=False)] = np.nan
    sparse = np.zeros(d)
    sparse[rng.choice(d, 3, replace=False)] = rng.standard_normal(3)
    heavy = np.where(rng.random(d) < 0.9, 1.5, -1.5) * (rng.random(d) < 0.8)
    return np.stack([ties, zeros, signed_zero, infs, nans, sparse, heavy])


@pytest.mark.parametrize("d,k", [(16, 4), (256, 32), (100, 10), (64, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_topk_special_rows_bitwise(d, k, dtype):
    _check(_special_rows(d, np.random.default_rng(d + k)), k, dtype)


def test_sparse_row_keeps_distinct_indices():
    """ROADMAP C2: on a row with fewer than k nonzeros the Pallas loop
    repeats an index ([0, 4, 0, 0]); lax.top_k and the port take the
    lowest-index zeros ([0, 4, 1, 2])."""
    x = np.array([[5.0, 0, 0, 0, -3.0, 0]])
    tv, ti = _check(x, 4, "float32")
    assert ti.tolist() == [[0, 4, 1, 2]]
    assert tv.tolist() == [[5.0, -3.0, 0.0, 0.0]]


def test_nan_first_then_inf():
    """lax.top_k puts NaN magnitudes first (ties by index), then inf; the
    port's order is the same."""
    x = np.array([[1.0, np.nan, 3.0, -np.inf, np.nan, 0.0, -0.0, 2.0,
                   np.inf, -np.nan]])
    _, ti = _check(x, 10, "float32")
    assert ti.tolist() == [[1, 4, 9, 3, 8, 2, 7, 0, 5, 6]]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decompress_equals_jax(dtype):
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.standard_normal((5, 100)), dtype)
    jv, ji = j_topk(jx, 10, use_pallas=False)
    tv, ti = topk_compress(tx, 10)
    np.testing.assert_array_equal(
        _bits(decompress(tv, ti, 100)), _bits(j_decompress(jv, ji, 100)))


@pytest.mark.parametrize("shape,k", [((2, 3, 4), 1), ((4,), 1), ((2, 4), 0),
                                     ((2, 4), 5)])
def test_bad_input_rejected_like_jax(shape, k):
    with pytest.raises(ValueError, match="bad input"):
        j_topk(jnp.zeros(shape), k, use_pallas=False)
    with pytest.raises(ValueError, match="bad input"):
        topk_compress(torch.zeros(shape), k)
    with pytest.raises(ValueError, match="bad input"):
        topk_threshold(torch.zeros(shape), k)


def test_cuda_launchers_refuse_cpu_tensors():
    before = (topk_compress_cuda.launches, topk_threshold_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        topk_compress_cuda(torch.zeros(2, 8), 2)
    with pytest.raises(ValueError, match="CUDA"):
        topk_threshold_cuda(torch.zeros(2, 8), 2)
    topk_compress(torch.ones(2, 8), 2)          # the CPU takes the plain one
    assert (topk_compress_cuda.launches,
            topk_threshold_cuda.launches) == before
