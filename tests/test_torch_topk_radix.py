"""The top-k kernel's steps on the CPU (``ref.topk_*_radix_torch``).

The CUDA top-k (``csrc/topk_compress.cu``) selects the threshold by a radix
select over 11-bit digits of the magnitude key (three passes for float32,
two for bfloat16), filters the third pass through a candidate buffer when
the first pass's bin fits it, compacts in index order and orders the k
pairs by a stable LSD sort on ~key in three 11-bit passes, skipping a pass
whose digit is the same for all k keys. Its plain twins repeat those steps
and are held bit for bit, on numpy-seeded rows, against the port's stable
sort and the JAX package's ``lax.top_k`` oracle: random rows at the JAX
test shapes and longer than one block's row, rows of ties, zeros, ±0,
±inf, NaN, fewer than k nonzeros and heavy ties, rows that overflow a
small candidate buffer, and rows where every key shares the first digit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_compress.ref import topk_compress_ref
from repro_torch.kernels.topk_compress.ref import (
    SMALL_ROW, candidate_cap, magnitude_keys, topk_compress_radix_torch,
    topk_compress_torch, topk_order_lsd_torch, topk_select_radix_torch,
    topk_threshold_radix_torch, topk_threshold_torch)
from repro_torch.kernels.topk_compress.topk_compress import select_launches

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (R, D, k): the JAX test shapes, then rows past one block's 16,384 (row 1
# of 20,003 float32 values starts off 16 bytes)
SHAPES = [(1, 16, 4), (8, 256, 32), (5, 100, 10), (3, 20_003, 200),
          (1, 40_000, 4_000)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(x: np.ndarray, dtype: str):
    jdt, _ = DTYPES[dtype]
    jx = jnp.asarray(x, jdt)
    a = np.array(jx)
    if dtype == "bfloat16":
        return jx, torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return jx, torch.from_numpy(a)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return a.view(view.get(a.dtype, a.dtype)).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a.view(np.int32)


def _check(x: np.ndarray, k: int, dtype: str, cap=None):
    """The twins bitwise against the stable sort and against JAX."""
    jx, tx = _both(x, dtype)
    tv, ti = topk_compress_radix_torch(tx, k, cap)
    wv, wi = topk_compress_torch(tx, k)
    jv, ji = topk_compress_ref(jx, k)
    np.testing.assert_array_equal(ti.numpy(), wi.numpy())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(tv), _bits(wv))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    got = topk_threshold_radix_torch(tx, k, cap)
    want = topk_threshold_torch(tx, k)
    lax = np.asarray(jax.lax.top_k(jnp.abs(jx.astype(jnp.float32)), k)[0]
                     )[:, -1]
    nan = np.isnan(lax)
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])
    np.testing.assert_array_equal(_bits(got)[~nan], lax[~nan].view(np.int32))
    keys = magnitude_keys(tx)
    for st, row in zip(topk_select_radix_torch(tx, k, cap), keys):
        assert st["n_gt"] == int((row > st["prefix"]).sum()) < k
        assert st["n_eq"] == int((row == st["prefix"]).sum())
        assert st["n_gt"] + st["n_eq"] >= k
    return topk_select_radix_torch(tx, k, cap)


def _special_rows(d: int, rng) -> np.ndarray:
    ties = rng.integers(-3, 4, size=d).astype(np.float64)
    signed_zero = np.where(rng.random(d) < 0.5, -0.0, 0.0)
    infs = rng.standard_normal(d)
    infs[rng.choice(d, 5, replace=False)] = np.inf
    infs[rng.choice(d, 5, replace=False)] = -np.inf
    nans = rng.standard_normal(d)
    nans[rng.choice(d, 3, replace=False)] = np.nan
    sparse = np.zeros(d)
    sparse[rng.choice(d, 3, replace=False)] = rng.standard_normal(3)
    heavy = np.where(rng.random(d) < 0.9, 1.5, -1.5) * (rng.random(d) < 0.8)
    return np.stack([ties, np.zeros(d), signed_zero, infs, nans, sparse,
                     heavy])


@pytest.mark.parametrize("r,d,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_radix_twin_bitwise_on_random_rows(r, d, k, dtype):
    sel = _check(np.random.default_rng(r * 1000 + d).standard_normal((r, d)),
                 k, dtype)
    # a float32 row past one block filters its last pass through the
    # candidates; bfloat16 and short rows never do
    want = dtype == "float32" and d > SMALL_ROW
    assert all(s["from_candidates"] == want for s in sel)


@pytest.mark.parametrize("d,k", [(256, 32), (100, 10), (64, 64),
                                 (20_000, 200)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_radix_twin_bitwise_on_special_rows(d, k, dtype):
    sel = _check(_special_rows(d, np.random.default_rng(d + k)), k, dtype)
    if d > SMALL_ROW and dtype == "float32":
        # heavy ties (72% of the keys 1.5) overflow the D / 16 buffer
        assert sel[-1]["from_candidates"] is False


@pytest.mark.parametrize("cap", [8, 0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_radix_twin_overflows_a_small_candidate_cap(cap, dtype):
    x = np.random.default_rng(5).standard_normal((2, 20_001))
    sel = _check(x, 300, dtype, cap=cap)
    assert not any(s["from_candidates"] for s in sel)


@pytest.mark.parametrize("cap", [None, 20_000])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_radix_twin_when_every_key_shares_the_first_digit(cap, dtype):
    """|x| in [1, 1.125): bits 30-20 of every key agree, so pass 1's bin is
    the whole row: beyond the default buffer (the row read again), within
    a buffer of the row's size."""
    rng = np.random.default_rng(11)
    x = (1 + rng.random((1, 20_000)) / 8.5) * rng.choice([-1, 1], (1, 20_000))
    _, tx = _both(x, dtype)
    assert len(set((magnitude_keys(tx) >> 20).flatten().tolist())) == 1
    sel = _check(x, 777, dtype, cap=cap)
    assert sel[0]["from_candidates"] is (dtype == "float32"
                                          and cap is not None)


@pytest.mark.parametrize("dtype,ran", [("float32", [True, True, True]),
                                       ("bfloat16", [False, True, True])])
def test_lsd_order_twin_equals_the_stable_sort(dtype, ran):
    """Three 11-bit passes on ~key equal a stable descending sort of the
    keys; a bfloat16 key's lowest 11 bits are all zero, so its first pass
    is skipped."""
    _, tx = _both(np.random.default_rng(2).standard_normal((1, 5_000)),
                  dtype)
    keys = magnitude_keys(tx)[0]
    idx = torch.arange(keys.numel())
    got_k, got_i, got_ran = topk_order_lsd_torch(keys, idx)
    want = torch.sort(keys, descending=True, stable=True)
    assert torch.equal(got_k, want.values) and torch.equal(got_i,
                                                           want.indices)
    assert got_ran == ran


def test_lsd_order_twin_keeps_index_order_among_ties():
    keys = torch.tensor([5, 7, 5, 0x7fc00000, 7, 0, 5], dtype=torch.int64)
    got_k, got_i, ran = topk_order_lsd_torch(keys, torch.arange(7))
    assert got_i.tolist() == [3, 1, 4, 0, 2, 6, 5]
    assert got_k.tolist() == [0x7fc00000, 7, 7, 5, 5, 5, 0]
    same = torch.full((4,), 9, dtype=torch.int64)
    assert topk_order_lsd_torch(same, torch.arange(4))[2] == [False] * 3


def test_candidate_cap_and_launch_counts():
    assert candidate_cap(SMALL_ROW) == 0
    assert candidate_cap(781_189_120) == 48_824_320
    assert candidate_cap(20_001, 10) == 8
    assert [select_launches(dt, d) for dt in (torch.float32, torch.bfloat16)
            for d in (5_120, SMALL_ROW, SMALL_ROW + 1)] == [1, 1, 4, 1, 1, 3]
