"""The port's masked group sum on the CPU vs the JAX package's.

The same numpy-seeded inputs go through ``repro.kernels.segment_reduce``
(the jnp oracle ``segment_reduce_ref`` and the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it) and through
``repro_torch.kernels.segment_reduce`` on CPU tensors, which take the plain
version. Tolerances are those of ``tests/test_kernels.py``: float32 rtol
2e-5, atol 1e-6 (the oracle's einsum sums in another order than the left
fold); bfloat16 rtol 2e-2, atol 1e-2. On integer-valued inputs every order
sums exactly, so there the results must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce.ops import segment_reduce as j_segment_reduce
from repro.kernels.segment_reduce.ref import segment_reduce_ref
from repro.kernels.segment_reduce.segment_reduce import segment_reduce_pallas
from repro_torch.kernels.segment_reduce.ops import reduce_rows, segment_reduce
from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
from repro_torch.kernels.segment_reduce.segment_reduce import (
    segment_reduce_cuda)

SHAPES = [(1, 1, 8), (4, 7, 130), (16, 32, 512), (3, 5, 1000)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x, mask, dtype):
    """The same values in both packages: JAX rounds to ``dtype`` first and
    the port receives exactly those values."""
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype])
    return jx, jnp.asarray(mask), tx, torch.as_tensor(mask)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("g,c,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_oracle_and_pallas(g, c, d, dtype):
    rng = np.random.default_rng(g * 100 + c)
    jx, jm, tx, tm = _both(rng.normal(size=(g, c, d)),
                           rng.random((g, c)) < 0.7, dtype)
    got = segment_reduce(tx, tm)
    assert got.dtype == DTYPES[dtype] and tuple(got.shape) == (g, d)
    tol = (dict(rtol=2e-2, atol=1e-2) if dtype == "bfloat16"
           else dict(rtol=2e-5, atol=1e-6))
    for want in (segment_reduce_ref(jx, jm),
                 segment_reduce_pallas(jx, jm, interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("g,c,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_integer_inputs_equal(g, c, d, dtype):
    """Sums of small integers are exact in float32 and, below 256, in
    bfloat16: the port equals the oracle and the Pallas kernel. Zero sums
    are compared by value (the port's sum starts at +0; see ref.py)."""
    rng = np.random.default_rng(7 * g + c)
    jx, jm, tx, tm = _both(rng.integers(-4, 5, size=(g, c, d)),
                           rng.random((g, c)) < 0.7, dtype)
    got = _f32(segment_reduce(tx, tm))
    np.testing.assert_array_equal(got, _f32(segment_reduce_ref(jx, jm)))
    np.testing.assert_array_equal(
        got, _f32(segment_reduce_pallas(jx, jm, interpret=True)))


def test_left_fold_order_and_skipped_rows():
    """The sum is ((0 + x_0) + x_1) + ... in ascending c, products and sums
    rounded one at a time; a row whose mask is 0 is left out, so a NaN
    there does not reach the sum, and an empty mask gives +0."""
    x = torch.tensor([[[1.0], [2.0 ** -24], [2.0 ** -24], [float("nan")]],
                      [[-3.0], [1.0], [0.5], [2.0]]])
    mask = torch.tensor([[1, 1, 1, 0], [0, 0, 0, 0]])
    got = segment_reduce(x, mask)
    # 1 + 2^-24 rounds back to 1 twice; a tree sum would keep 2^-23
    assert got[0, 0].item() == 1.0
    assert got[1, 0].item() == 0.0 and not torch.signbit(got[1, 0])
    w = torch.tensor([[0.5, 3.0, 0.0, 0.0], [2.0, 0.0, 0.0, -1.0]])
    want = torch.stack([0.5 * x[0, 0] + 3.0 * x[0, 1], 2.0 * x[1, 0]
                        - 1.0 * x[1, 3]])
    assert torch.equal(segment_reduce(x, w), want)


def test_rows_form_equals_stacked_form():
    """The executor's form: group g reads rows rows[g] + c of a (R, D)
    buffer; in place, it writes each sum over its span's first row."""
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.normal(size=(40, 9)), dtype=torch.float32)
    rows = torch.tensor([0, 10, 33])
    mask = torch.as_tensor(rng.random((3, 7)) < 0.6)
    mask[2, 5:] = False                     # rows past the end: masked out
    stacked = flat[(rows[:, None] + torch.arange(7)).clamp(max=39)]
    want = segment_reduce_torch(stacked, mask)
    assert torch.equal(reduce_rows(flat, mask, rows), want)
    out = flat.clone()
    reduce_rows(out, mask, rows, inplace=True)
    assert torch.equal(out[rows], want)
    untouched = torch.ones(40, dtype=torch.bool)
    untouched[rows] = False
    assert torch.equal(out[untouched], flat[untouched])


@pytest.mark.parametrize("xs,ms", [((2, 3, 4), (2, 4)), ((2, 3, 4), (3,)),
                                   ((2, 3), (2, 3)), ((2, 3, 4), (3, 2))])
def test_bad_shapes_rejected_like_jax(xs, ms):
    with pytest.raises(ValueError, match="bad shapes"):
        j_segment_reduce(jnp.zeros(xs), jnp.ones(ms, bool))
    with pytest.raises(ValueError, match="bad shapes"):
        segment_reduce(torch.zeros(xs), torch.ones(ms, dtype=torch.bool))


def test_cuda_launcher_refuses_cpu_tensors():
    before = segment_reduce_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce_cuda(torch.zeros(2, 3, 4), torch.ones(2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        segment_reduce_cuda(torch.zeros(8, 4), torch.ones(2, 3),
                            torch.tensor([0, 4]), inplace=True)
    assert segment_reduce_cuda.launches == before


@pytest.mark.parametrize("inplace", [False, True])
def test_round_each_rounds_after_every_add(inplace):
    """``round_each=True`` is bfloat16 addition: the sum is rounded to
    bfloat16 after every add (as the JAX executor's bfloat16 fold carry
    is), where the default rounds once at the end. 1 + 2^-8 rounds back to
    1 in bfloat16, so two such adds leave 1; summed in float32 first they
    reach 1 + 2^-7. Float32 is unchanged by the flag. The executor's
    ``reduce_rows`` always rounds after every add."""
    x = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -8]).reshape(3, 1)
    rows, mask = torch.tensor([0]), torch.ones(1, 3)
    for dt, each, want in ((torch.bfloat16, True, 1.0),
                           (torch.bfloat16, False, 1.0 + 2.0 ** -7),
                           (torch.float32, True, 1.0 + 2.0 ** -7),
                           (torch.float32, False, 1.0 + 2.0 ** -7)):
        assert torch.equal(segment_reduce_torch(x.to(dt)[None], mask,
                                                round_each=each)[0],
                           torch.tensor([want], dtype=dt)), (dt, each)
        if each:
            flat = x.to(dt).clone()
            out = reduce_rows(flat, mask, rows, inplace=inplace)
            got = (flat[0] if inplace else out[0]).item()
            assert got == want, dt
