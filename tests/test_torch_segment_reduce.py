"""The port's masked group sum on the CPU vs the JAX package's.

The same numpy-seeded inputs go through ``repro.kernels.segment_reduce``
(the jnp oracle ``segment_reduce_ref`` and the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it) and through
``repro_torch.kernels.segment_reduce`` on CPU tensors, which take the plain
version, in the JAX API's stacked (G, C, D) form and in the executor's
gather-table form (rows of a source and of a scratch of partials).
Tolerances are those of ``tests/test_kernels.py``: float32 rtol 2e-5,
atol 1e-6 (the oracle's einsum sums in another order than the left fold);
bfloat16 rtol 2e-2, atol 1e-2. On integer-valued inputs every order
sums exactly, so there the results must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce.ops import segment_reduce as j_segment_reduce
from repro.kernels.segment_reduce.ref import segment_reduce_ref
from repro.kernels.segment_reduce.segment_reduce import segment_reduce_pallas
from repro_torch.kernels.segment_reduce.ops import reduce_table, segment_reduce
from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
from repro_torch.kernels.segment_reduce.segment_reduce import (
    MIN_TILE, SMS, segment_reduce_cuda, tile_of)

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
    """The executor's table form: group g reads the rows its table names
    (of a (R0, D) source, then of a scratch), in table order; with ``out``
    it writes each sum over row ``out_rows[g]`` and leaves the rest."""
    rng = np.random.default_rng(3)
    flat = torch.as_tensor(rng.normal(size=(40, 9)), dtype=torch.float32)
    starts = torch.tensor([0, 10, 33])
    mask = torch.as_tensor(rng.random((3, 7)) < 0.6)
    mask[2, 5:] = False
    table = starts[:, None] + torch.arange(7)
    table[mask.logical_not()] = -1         # rows past the end: not named
    stacked = flat[(starts[:, None] + torch.arange(7)).clamp(max=39)]
    want = segment_reduce_torch(stacked, mask)
    assert torch.equal(reduce_table(flat, table), want)
    # the same rows named from a scratch (entry R0 + i is scratch row i)
    assert torch.equal(reduce_table(flat[:0], table, scratch=flat), want)
    out = flat.clone()
    rows = torch.tensor([39, 1, 20])
    assert reduce_table(flat, table, out=out, out_rows=rows) is out
    assert torch.equal(out[rows], want)
    untouched = torch.ones(40, dtype=torch.bool)
    untouched[rows] = False
    assert torch.equal(out[untouched], flat[untouched])


def _table_case(rng, g, c, r0, p, d, dtype):
    """Source rows, scratch rows and a table over both with repeats and
    -1 entries; values over many magnitudes, so that order shows."""
    x, s = (torch.as_tensor(rng.standard_normal((n, d))
                            * np.exp(2 * rng.standard_normal((n, d))),
                            dtype=torch.float32).to(dtype) for n in (r0, p))
    table = torch.as_tensor(rng.integers(-1, r0 + p, size=(g, c)))
    table[0, : min(c, 3)] = r0 + p - 1        # a repeat, from the scratch
    return x, s, table


def _fold(x, s, table, mask, round_each):
    """The left fold spelled entry by entry."""
    src = torch.cat([x, s]).to(torch.float32)
    out = torch.zeros((table.shape[0], x.shape[1]), dtype=torch.float32)
    for g in range(table.shape[0]):
        for c in range(table.shape[1]):
            e, m = int(table[g, c]), float(mask[g, c])
            if e < 0 or m == 0:
                continue
            out[g] = out[g] + torch.tensor(m, dtype=x.dtype).float() * src[e]
            if round_each:
                out[g] = out[g].to(x.dtype).float()
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("g,c,r0,p,d", [(1, 1, 1, 0, 8), (3, 6, 4, 5, 33),
                                        (8, 17, 9, 12, 130),
                                        (2, 40, 3, 2, 1000)])
def test_table_mixes_x_and_scratch_rows(g, c, r0, p, d, dtype):
    """Entries below R0 read x, the others the scratch; repeats read a row
    again, -1 and a zero weight read nothing; the fold runs in table order
    (bfloat16 rounded after every add under ``round_each``)."""
    rng = np.random.default_rng(g * 31 + c)
    x, s, table = _table_case(rng, g, c, r0, p, d, DTYPES[dtype])
    mask = torch.as_tensor(rng.random((g, c)) < 0.8).float()
    mask[-1, -1] = 0.5
    for each in (False, True):
        want = _fold(x, s, table, mask, each)
        got = segment_reduce_torch(x, mask, table, scratch=s,
                                   round_each=each)
        assert torch.equal(got, want), each
    ones = torch.ones_like(mask)
    assert torch.equal(reduce_table(x, table, scratch=s),
                       _fold(x, s, table, ones, True))


@pytest.mark.parametrize("g,c,d", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_table_form_matches_stacked_jax_oracle_and_pallas(g, c, d, dtype):
    """The stacked form is the table ``g * C + c`` over ``x.view(G * C,
    D)``: the rows of the (G, C, D) input, shuffled into a source and
    named by a table, give the stacked form's bits, and the JAX oracle's
    and the Pallas kernel's sums within their tolerances (exactly on
    integer inputs)."""
    rng = np.random.default_rng(g * 10 + c + d)
    for vals in (rng.normal(size=(g, c, d)),
                 rng.integers(-4, 5, size=(g, c, d))):
        jx, jm, tx, tm = _both(vals, rng.random((g, c)) < 0.7, dtype)
        perm = torch.as_tensor(rng.permutation(g * c))
        src = tx.reshape(g * c, d)[perm]
        table = torch.argsort(perm).view(g, c)     # src[table] == tx
        got = segment_reduce_torch(src, tm, table)
        assert torch.equal(got, segment_reduce(tx, tm))
        table = table.where(tm, torch.full_like(table, -1))
        assert torch.equal(segment_reduce_torch(src, None, table), got)
        exact = vals.dtype.kind == "i"
        tol = (dict(rtol=0, atol=0) if exact
               else dict(rtol=2e-2, atol=1e-2) if dtype == "bfloat16"
               else dict(rtol=2e-5, atol=1e-6))
        for want in (segment_reduce_ref(jx, jm),
                     segment_reduce_pallas(jx, jm, interpret=True)):
            np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_tile_of_fills_two_waves():
    """The launcher's d a block: 256 threads of 16 bytes, halved while the
    grid would fill fewer than two waves of the SMs, never below 256."""
    f32, bf16 = torch.float32, torch.bfloat16
    blocks = lambda g, d, t: g * -(-d // t)
    for dtype, widest in ((f32, 1024), (bf16, 2048)):
        for g in (1, 2, 3, 4, 8, 17, 64, 300, 65535):
            for d in (1, 8, 255, 1000, 4097, 65_536, 262_144, 6_553_600):
                t = tile_of(g, d, dtype)
                assert MIN_TILE <= t <= widest and widest % t == 0
                if t < widest:          # narrowed: the wider tile fell short
                    assert blocks(g, d, 2 * t) < 2 * SMS
                if blocks(g, d, MIN_TILE) >= 2 * SMS:
                    assert blocks(g, d, t) >= 2 * SMS
    assert tile_of(64, 6_553_600, f32) == 1024     # chip64-k16-d6.5m
    assert tile_of(1, 65_536, f32) == 256          # chip64-k0-d64k's root
    assert tile_of(4, 65_536, f32) == 512
    assert tile_of(1, 65_536, bf16) == 256
    assert tile_of(8, 6_553_600, bf16) == 2048


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
        segment_reduce_cuda(torch.zeros(8, 4), None,
                            torch.tensor([[0, 4, -1]]),
                            scratch=torch.zeros(2, 4), out=torch.zeros(2, 4),
                            out_rows=torch.tensor([1]))
    assert segment_reduce_cuda.launches == before


@pytest.mark.parametrize("inplace", [False, True])
def test_round_each_rounds_after_every_add(inplace):
    """``round_each=True`` is bfloat16 addition: the sum is rounded to
    bfloat16 after every add (as the JAX executor's bfloat16 fold carry
    is), where the default rounds once at the end. 1 + 2^-8 rounds back to
    1 in bfloat16, so two such adds leave 1; summed in float32 first they
    reach 1 + 2^-7. Float32 is unchanged by the flag. The executor's
    ``reduce_table`` always rounds after every add."""
    x = torch.tensor([1.0, 2.0 ** -8, 2.0 ** -8]).reshape(3, 1)
    table, mask = torch.tensor([[0, 1, 2]]), torch.ones(1, 3)
    for dt, each, want in ((torch.bfloat16, True, 1.0),
                           (torch.bfloat16, False, 1.0 + 2.0 ** -7),
                           (torch.float32, True, 1.0 + 2.0 ** -7),
                           (torch.float32, False, 1.0 + 2.0 ** -7)):
        assert torch.equal(segment_reduce_torch(x.to(dt)[None], mask,
                                                round_each=each)[0],
                           torch.tensor([want], dtype=dt)), (dt, each)
        if each:
            src = x.to(dt)
            if inplace:         # the sum over a row of the scratch
                out = torch.zeros(2, 1, dtype=dt)
                reduce_table(src, table, out=out,
                             out_rows=torch.tensor([1]))
                got = out[1].item()
            else:
                got = reduce_table(src, table)[0].item()
            assert got == want, dt
