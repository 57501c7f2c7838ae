"""The plain versions of the redesigned flash kernels on the CPU.

``ref.flash_attention_tc_torch`` repeats the tensor-core tile kernel's
arithmetic (online softmax over 128-key tiles in base 2, the weights
rounded to bfloat16 before P.V, l summed from the float32 weights);
``ref.flash_decode_split_torch`` repeats the split decode's (float32
partial states per split of keys, merged in split order). Each is held
against the JAX package's references on the same numpy-seeded inputs at
the JAX tests' tolerances (float32 2e-5, bfloat16 3e-2; the Pallas kernel
in interpret mode and ``flash_attention_ref``, as ``tests/test_kernels.py``
runs them) and, the tile arithmetic, against the float32 plain version
within the limit derived for it (``FLASH_TC`` in ``chip_smoke.py``):

    |got - want32| <= 2^-8 |want32| + (2^-8 + 2^-15) A + 2^-15,

A the float32 plain attention over |v|: bfloat16's unit roundoff u = 2^-8
once for each weight (at most u A in all) and once for the output (u |o|),
the float32 arithmetic under the atol. Planted faults must exceed it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models.attention import causal_mask as j_causal_mask
from repro.models.attention import sdpa as j_sdpa
from repro_torch.kernels.flash_attention.flash_attention import (
    DECODE_BLOCKS, SPLIT_MIN_KEYS, check_tma, decode_splits, path_of)
from repro_torch.kernels.flash_attention.ref import (
    TC_KEYS, flash_attention_gqa_torch, flash_attention_tc_torch,
    flash_decode_split_torch, sdpa, split_chunk)
from repro_torch.models.attention import causal_mask

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TC_LIMIT = {"rtol": 2.0 ** -8, "arel": 2.0 ** -8 + 2.0 ** -15,
            "atol": 2.0 ** -15}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(rng, shape, dtype=jnp.bfloat16):
    x = rng.normal(size=shape).astype(np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(tdt)


def _over_limit(got, q, k, v, scale, causal, window=0, mask=None):
    """max |got - want32| / limit against the float32 plain version (with
    ``mask``: ``sdpa`` under it)."""
    f = [x.to(torch.float32) for x in (q, k, v)]
    if mask is None:
        want = flash_attention_gqa_torch(*f, scale, causal, window)
        a32 = flash_attention_gqa_torch(f[0], f[1], f[2].abs(), scale,
                                        causal, window)
    else:
        want = sdpa(*f, mask, scale)
        a32 = sdpa(f[0], f[1], f[2].abs(), mask, scale)
    lim = (TC_LIMIT["rtol"] * want.abs() + TC_LIMIT["arel"] * a32
           + TC_LIMIT["atol"])
    return float(((got.to(torch.float32) - want).abs() / lim).max())


@pytest.mark.parametrize("bh,t,d", [(4, 128, 64), (1, 200, 128),
                                    (2, 200, 112)])
def test_tc_plain_matches_jax_on_its_test_shapes(bh, t, d):
    """The JAX test shapes at the head dims the tensor-core kernel takes,
    causal, bfloat16: against the Pallas kernel (interpret mode) and the
    oracle at the JAX tests' 3e-2."""
    rng = np.random.default_rng(bh * 31 + t)
    (jq, q), (jk, k), (jv, v) = (_both(rng, (bh, t, d)) for _ in range(3))
    got = flash_attention_tc_torch(q[:, :, None], k[:, :, None],
                                   v[:, :, None], d ** -0.5)[:, :, 0]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    for want in (j_flash(jq, jk, jv, causal=True),
                 flash_attention_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("d", [64, 128, 112])
@pytest.mark.parametrize("b,t,s,h,hkv,causal,window", [
    (2, 37, 101, 4, 2, False, 0), (2, 130, 61, 4, 1, True, 0),
    (1, 5, 300, 2, 2, True, 0), (2, 150, 150, 8, 2, True, 0),
    (2, 200, 200, 4, 2, True, 1), (2, 200, 200, 4, 2, True, 63),
    (1, 300, 300, 2, 1, True, 64), (2, 333, 333, 5, 1, True, 100)])
def test_tc_plain_within_derived_limit(d, b, t, s, h, hkv, causal, window):
    """Ragged T and S (causal T > S and T < S, bidirectional), GQA, windows
    1, 63, 64 and 100: within the derived limit of the float32 plain
    version, and within the JAX tests' 3e-2 of the JAX model's ``sdpa``."""
    rng = np.random.default_rng(t * 7 + s + window)
    jq, q = _both(rng, (b, t, h, d))
    (jk, k), (jv, v) = (_both(rng, (b, s, hkv, d)) for _ in range(2))
    scale = d ** -0.5
    got = flash_attention_tc_torch(q, k, v, scale, causal, window)
    assert _over_limit(got, q, k, v, scale, causal, window) <= 1.0
    if causal:
        jmask = j_causal_mask(t, s, window)[None]
    else:
        jmask = jnp.ones((1, t, s), bool)
    want = j_sdpa(jq, jk, jv, jmask, jnp.float32(scale))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("window", [0, 100])
def test_planted_tile_faults_exceed_the_limit(window):
    """What a faulty tile kernel would compute, rounded to bfloat16 as the
    kernel's output is, fails the limit the plain tile arithmetic meets:
    the diagonal shifted by one key (row i also sees key i + 1), one key
    tile dropped for every row, and the last query tile skipping the first
    key tile of its band (``chip_smoke.py``'s prefill fault)."""
    rng = np.random.default_rng(16 + window)
    b, t, h, hkv, d = 1, 256, 4, 2, 64
    q = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(
        np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.normal(size=(b, t, hkv, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    scale = d ** -0.5
    assert _over_limit(flash_attention_tc_torch(q, k, v, scale, True, window),
                       q, k, v, scale, True, window) <= 1.0
    good = causal_mask(t, t, window)
    keys = torch.arange(t)[None, :]
    shifted = causal_mask(t, t, window, offset=1)
    dropped = good & ((keys < TC_KEYS) | (keys >= 2 * TC_KEYS))
    q0 = (t - 1) // TC_KEYS * TC_KEYS
    k0 = max(0, q0 - window + 1) // TC_KEYS * TC_KEYS if window else 0
    skipped = good.clone()
    skipped[q0:, k0:k0 + TC_KEYS] = False
    f = [x.float() for x in (q, k, v)]
    for mask in (shifted, dropped, skipped):
        assert (mask != good).any()
        faulty = sdpa(*f, mask[None], scale).bfloat16()
        assert _over_limit(faulty, q, k, v, scale, True, window,
                           good[None]) > 1.0


@pytest.mark.parametrize("t", [8, 1500])
@pytest.mark.parametrize("mean,seen", [(1.0, True), (0.0, False)])
def test_zero_keys_past_a_ragged_s_show_only_below_zero_scores(t, mean,
                                                               seen):
    """whisper's 30-s window, S = 1,500 keys (36 short of a key tile),
    non-causal: the tile's tensor map reads zeros past S, so a kernel that
    let those keys in would weigh each by exp(0) and add nothing to P.V.
    With q drawn with mean 1 and k with mean -1 (every real score near
    -8, as ``chip_smoke.py``'s phase 18a and the card test draw them) that
    output fails the limit the tile arithmetic meets; with centred draws
    it stays within, so such draws could not see the fault."""
    rng = np.random.default_rng(t)
    b, s, h, d = 1, 1500, 2, 64
    q = torch.from_numpy(rng.normal(mean, size=(b, t, h, d)).astype(
        np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(-mean, size=(b, s, h, d)).astype(
        np.float32)).bfloat16()
    v = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
        np.float32)).bfloat16()
    scale = d ** -0.5
    assert _over_limit(flash_attention_tc_torch(q, k, v, scale, False),
                       q, k, v, scale, False) <= 1.0
    z = torch.zeros((b, -s % TC_KEYS, h, d), dtype=torch.bfloat16)
    assert z.shape[1] == 36
    f = [x.float() for x in (q, torch.cat([k, z], 1), torch.cat([v, z], 1))]
    faulty = flash_attention_gqa_torch(*f, scale, False).bfloat16()
    assert (_over_limit(faulty, q, k, v, scale, False) > 1.0) == seen


@pytest.mark.parametrize("causal", [True, False])
def test_next_heads_columns_at_112_exceed_the_limit(causal):
    """At (112, 112) the kernel's tensor maps keep the view's width 112 and
    TMA fills columns 112-127 of the second panel with zeros. A map
    declared 128 wide over the 112-wide view would read there the next
    head's first 16 columns (of q and of k) and add their product to
    every score; that fault, rounded to bfloat16 as the kernel's output
    is, fails the limit the plain tile arithmetic meets."""
    rng = np.random.default_rng(112 + causal)
    b, t, h, hkv, d = 1, 200, 4, 2, 112
    q, k, v = (torch.from_numpy(rng.normal(size=(b, t, n, d)).astype(
        np.float32)).bfloat16() for n in (h, hkv, hkv))
    scale = d ** -0.5
    got = flash_attention_tc_torch(q, k, v, scale, causal)
    assert _over_limit(got, q, k, v, scale, causal) <= 1.0
    # what a 128-wide map reads: the row's next 16 elements, head h + 1's
    # first columns (the last head's: the next row's head 0; past the
    # tensor's end, zeros here)
    def wide(x):
        flat = torch.cat([x.reshape(-1), x.new_zeros(16)])
        n_b, n_t, n_h, _ = x.shape
        return torch.as_strided(flat, (n_b, n_t, n_h, 128),
                                (n_t * n_h * d, n_h * d, d, 1))
    wide_q, wide_k = wide(q), wide(k)
    assert torch.equal(wide_q[..., :d], q) and torch.equal(wide_k[..., :d], k)
    assert torch.equal(wide_q[:, :, 0, d:], q[:, :, 1, :16])
    assert torch.equal(wide_k[:, :, 0, d:], k[:, :, 1, :16])
    assert torch.equal(wide_q[:, :-1, -1, d:], q[:, 1:, 0, :16])
    faulty = flash_attention_gqa_torch(wide_q.float(), wide_k.float(),
                                       v.float(), scale, causal).bfloat16()
    assert _over_limit(faulty, q, k, v, scale, causal) > 1.0


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 17])
def test_decode_split_matches_plain_and_jax(n, n_split):
    """Partial states per split, merged in split order, on a strided cache
    prefix ``[:, :n]``: equal to the plain version and to the JAX model's
    ``sdpa`` over the whole cache with the slots past n masked, at the JAX
    tests' float32 tolerance. Seventeen splits are more than the tiles of
    every n here, so trailing splits come out empty."""
    rng = np.random.default_rng(n * 10 + n_split)
    s_all = 1010
    jq, q = _both(rng, (2, 1, 8, 64), jnp.float32)
    (jk, k), (jv, v) = (_both(rng, (2, s_all, 2, 64), jnp.float32)
                        for _ in range(2))
    kp, vp = k[:, :n], v[:, :n]
    assert not kp.is_contiguous() or n == s_all
    got = flash_decode_split_torch(q, kp, vp, 0.125, n_split)
    torch.testing.assert_close(
        got, flash_attention_gqa_torch(q, kp, vp, 0.125, causal=False),
        rtol=TOL["float32"], atol=TOL["float32"])
    mask = (jnp.arange(s_all) < n)[None, None, :]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_sdpa(jq, jk, jv, mask, jnp.float32(0.125))),
        rtol=TOL["float32"], atol=TOL["float32"])
    chunk = split_chunk(n, n_split)
    empty = sum(s * chunk >= n for s in range(n_split))
    assert chunk % 64 == 0 and empty >= (n_split == 17)


def test_decode_split_on_a_ring_prefix_and_its_fault():
    """A windowed layer's ring (slot p % S, all S slots filled) in bfloat16,
    against ``sdpa`` over the ring; one split's partial left out of the
    merge fails the float32 tolerance that the merge meets."""
    rng = np.random.default_rng(1024)
    q = torch.from_numpy(rng.normal(size=(2, 1, 5, 64)).astype(np.float32))
    ring_k, ring_v = (torch.from_numpy(rng.normal(
        size=(2, 1024, 1, 64)).astype(np.float32)) for _ in range(2))
    n_split = decode_splits(1024, 2)
    assert n_split == 8 and split_chunk(1024, n_split) == 128
    got = flash_decode_split_torch(q, ring_k, ring_v, 0.125, n_split)
    want = sdpa(q, ring_k, ring_v, None, 0.125)
    torch.testing.assert_close(got, want, rtol=TOL["float32"],
                               atol=TOL["float32"])
    keep = torch.ones((1, 1, 1024), dtype=torch.bool)
    keep[..., 3 * 128:4 * 128] = False        # split 3's keys
    faulty = sdpa(q, ring_k, ring_v, keep, 0.125)
    assert (faulty - want).abs().max() > 100 * TOL["float32"]
    gb = flash_decode_split_torch(q.bfloat16(), ring_k.bfloat16(),
                                  ring_v.bfloat16(), 0.125, n_split)
    torch.testing.assert_close(gb.float(), want, rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


def test_decode_splits_fill_the_card_with_long_enough_splits():
    """The split count: about DECODE_BLOCKS blocks, at least
    SPLIT_MIN_KEYS keys a split, at least one split; the same for the same
    shapes. The serving cells: qwen3-32b (4 x 8 KV heads) over 2,112
    positions, hymba (4 x 5) over 32,832 and its 1,024-slot ring."""
    assert decode_splits(2112, 32) == 8
    assert decode_splits(32832, 20) == 13
    assert decode_splits(1024, 20) == 8
    assert decode_splits(1, 32) == 1 and decode_splits(127, 1) == 1
    for n in (1, 100, 129, 4000, 100_000):
        for blocks in (1, 7, 32, 300):
            ns = decode_splits(n, blocks)
            assert ns >= 1 and (ns == 1 or n // ns >= SPLIT_MIN_KEYS)
            assert ns <= max(1, round(DECODE_BLOCKS / blocks))
            assert ns * split_chunk(n, ns) >= n


def test_path_and_tma_checks_on_cpu_tensors():
    """Which kernel a call takes (by T, dtype and D only), and the 16-byte
    checks the tensor-core kernel's tensor maps need, raised on."""
    bf, f32 = torch.bfloat16, torch.float32
    assert path_of(torch.zeros(2, 1, 4, 128, dtype=bf)) == "decode_split"
    assert path_of(torch.zeros(2, 1, 4, 64)) == "decode_split"
    assert path_of(torch.zeros(2, 9, 4, 128, dtype=bf)) == "tile_tc"
    assert path_of(torch.zeros(2, 9, 4, 64, dtype=bf)) == "tile_tc"
    assert path_of(torch.zeros(2, 9, 4, 64, dtype=f32)) == "tile_simt"
    assert path_of(torch.zeros(2, 9, 4, 48, dtype=bf)) == "tile_simt"
    # kimi-k2's head width: bfloat16 on the tensor cores at (112, 112)
    # only; float32, and values narrower than 112, on the CUDA cores
    assert path_of(torch.zeros(1, 9, 64, 112, dtype=bf)) == "tile_tc"
    assert path_of(torch.zeros(1, 9, 64, 112, dtype=bf), 112) == "tile_tc"
    assert path_of(torch.zeros(1, 9, 64, 112, dtype=f32)) == "tile_simt"
    assert path_of(torch.zeros(1, 9, 64, 112, dtype=bf), 96) == "tile_simt"
    assert path_of(torch.zeros(1, 1, 64, 112, dtype=bf)) == "decode_split"
    # the q, k, v of a fused projection, sliced: strided, 16-byte multiples
    qkv = torch.zeros(2, 40, 12 * 64, dtype=bf).view(2, 40, 12, 64)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    check_tma(q, k, v)
    check_tma(q, k[:, :17], v[:, :17])        # a cache prefix
    odd = torch.zeros(2, 40, 4 * 64 + 4, dtype=bf)[:, :, 4:].view(2, 40, 4,
                                                                   64)
    with pytest.raises(ValueError, match="16-byte"):
        check_tma(odd, k, v)
    strided = torch.zeros(2, 40, 3, 68, dtype=bf)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        check_tma(q, strided, strided)
    # 112 bf16 values are 224 bytes: heads and rows of a 112-wide
    # projection stay on 16-byte multiples
    qkv = torch.zeros(1, 40, 80 * 112, dtype=bf).view(1, 40, 80, 112)
    check_tma(qkv[:, :, :64], qkv[:, :, 64:72], qkv[:, :, 72:])
