"""The port's flash attention on the CPU vs the JAX package's.

The same numpy-seeded inputs go through ``repro.kernels.flash_attention``
(the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it,
and the oracle ``flash_attention_ref``) and through
``repro_torch.kernels.flash_attention.ops`` on CPU tensors, which take the
plain version; on the model's layout the reference is the JAX model's
``sdpa``. Tolerances are the JAX tests' (``tests/test_kernels.py``):
float32 rtol = atol = 2e-5, for summation order; bfloat16 3e-2, for the
8-bit mantissa of the logits, weights and outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models.attention import causal_mask, sdpa
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_cuda, geometry)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_gqa)
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_gqa_torch, sdpa as torch_sdpa)
from repro_torch.models.attention import causal_mask as torch_causal_mask

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(rng, shape, dtype):
    """The same values in both packages: float32 from numpy, then each
    rounds to ``dtype`` (to nearest even)."""
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, dtype, err_msg=""):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=err_msg)


@pytest.mark.parametrize("bh,t,d", [(2, 64, 32), (4, 128, 64), (1, 200, 128),
                                    (3, 256, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_causal_matches_jax(bh, t, d, dtype):
    rng = np.random.default_rng(bh * 31 + t)
    (jq, q), (jk, k), (jv, v) = (_both(rng, (bh, t, d), dtype)
                                 for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, j_flash(jq, jk, jv, causal=True), dtype, "vs Pallas")
    _close(got, flash_attention_ref(jq, jk, jv, causal=True), dtype,
           "vs ref")


def test_flash_attention_bidirectional_matches_jax():
    rng = np.random.default_rng(9)
    (jq, q), (jk, k), (jv, v) = (_both(rng, (2, 128, 32), "float32")
                                 for _ in range(3))
    got = flash_attention(q, k, v, causal=False)
    _close(got, j_flash(jq, jk, jv, causal=False), "float32", "vs Pallas")
    _close(got, flash_attention_ref(jq, jk, jv, causal=False), "float32")


@pytest.mark.parametrize("t,s,causal", [(37, 101, False), (130, 61, False),
                                        (70, 200, True), (130, 61, True),
                                        (300, 200, True), (1, 77, False),
                                        (5, 300, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_matches_ref(t, s, causal, dtype):
    """Any T and S: the JAX wrapper pads (causal) or falls back to the
    oracle (bidirectional); the port's kernel masks keys >= S itself, so
    the oracle is the reference."""
    rng = np.random.default_rng(t * 7 + s)
    jq, q = _both(rng, (2, t, 48), dtype)
    (jk, k), (jv, v) = (_both(rng, (2, s, 48), dtype) for _ in range(2))
    got = flash_attention(q, k, v, causal=causal)
    _close(got, flash_attention_ref(jq, jk, jv, causal=causal), dtype)
    if not causal or t <= s:
        _close(got, j_flash(jq, jk, jv, causal=causal), dtype, "vs Pallas")


def test_jax_causal_wrapper_lets_padded_keys_in_when_t_exceeds_s():
    """ROADMAP C12: with causal, T > S and S > 128 not a multiple of 128,
    the JAX wrapper pads the keys to 256 with zeros that only the causal
    mask keeps out, so rows at or past S see logit-0 keys with v = 0 and
    differ from the oracle. The port (kernel and plain version) follows
    the oracle."""
    rng = np.random.default_rng(3)
    jq, q = _both(rng, (2, 300, 48), "float32")
    (jk, k), (jv, v) = (_both(rng, (2, 200, 48), "float32")
                        for _ in range(2))
    pallas = np.asarray(j_flash(jq, jk, jv, causal=True))
    ref = np.asarray(flash_attention_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(pallas[:, :200], ref[:, :200], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(pallas[:, 200:] - ref[:, 200:]).max() > 0.01
    _close(flash_attention(q, k, v, causal=True), ref, "float32")


def _scale(hd: int):
    """1/sqrt(hd) as the JAX model rounds it (float32)."""
    js = 1.0 / jnp.sqrt(hd).astype(jnp.float32)
    return js, float(js)


@pytest.mark.parametrize("h,hkv", [(8, 2), (4, 1), (4, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_layout_matches_jax_sdpa(h, hkv, dtype):
    rng = np.random.default_rng(h * 10 + hkv)
    jq, q = _both(rng, (2, 40, h, 32), dtype)
    (jk, k), (jv, v) = (_both(rng, (2, 40, hkv, 32), dtype)
                        for _ in range(2))
    js, scale = _scale(32)
    want = sdpa(jq, jk, jv, causal_mask(40, 40)[None], js)
    _close(flash_attention_gqa(q, k, v, scale, causal=True), want, dtype)


@pytest.mark.parametrize("pos", [0, 17, 63])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_prefix_view_matches_masked_full_cache(pos, dtype):
    """A decode attends to the cache prefix ``[:, :pos + 1]``, a strided
    view; JAX's decode runs ``sdpa`` over the whole cache with the slots
    past ``pos`` masked."""
    rng = np.random.default_rng(pos)
    jq, q = _both(rng, (2, 1, 8, 32), dtype)
    (jk, k), (jv, v) = (_both(rng, (2, 64, 2, 32), dtype) for _ in range(2))
    js, scale = _scale(32)
    mask = (jnp.arange(64) <= pos)[None, None, :]
    want = sdpa(jq, jk, jv, mask, js)
    kp, vp = k[:, :pos + 1], v[:, :pos + 1]
    assert kp.data_ptr() == k.data_ptr() and not (
        pos < 63 and kp.is_contiguous())
    _close(flash_attention_gqa(q, kp, vp, scale, causal=False), want, dtype)


def test_plain_gqa_offset_is_a_row_block_of_the_full_causal_call():
    """A causal mask with ``offset`` places query row i at position
    offset + i: the plain ``sdpa`` over a block of rows equals the same
    rows of the whole causal call (how long calls are checked in row
    blocks)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 96, 4, 16)).astype(
        np.float32)) for _ in range(3))
    full = flash_attention_gqa_torch(q, k, v, 0.25, causal=True)
    mask = torch_causal_mask(32, 96, offset=64)[None]
    part = torch_sdpa(q[:, 64:], k, v, mask, 0.25)
    torch.testing.assert_close(part, full[:, 64:], rtol=2e-5, atol=2e-5)


def test_geometry_gives_the_kernel_strides_of_views():
    """What the launcher hands the kernel, checked here on CPU tensors:
    elements strides of strided views, head grouping, a value width of
    its own (MLA's values, a view of the up-projection), and refusals."""
    cache = torch.zeros((3, 50, 2, 64), dtype=torch.bfloat16)
    q = torch.zeros((3, 1, 8, 64), dtype=torch.bfloat16)
    g = geometry(q, cache[:, :20], cache[:, :20])
    assert g == (3, 1, 20, 8, 2, 64, 64, 512, 512, 64, 6400, 128, 64, 6400,
                 128, 64)
    x = torch.zeros((6, 10, 16))
    assert geometry(x[:, :, None], x[:, :, None], x[:, :, None])[:7] == (
        6, 10, 10, 1, 1, 16, 16)
    qm = torch.zeros((2, 7, 4, 96), dtype=torch.bfloat16)
    kv = torch.zeros((2, 7, 4, 128), dtype=torch.bfloat16)
    assert geometry(qm, qm, kv[..., 64:]) == (
        2, 7, 7, 4, 4, 96, 64, 2688, 384, 96, 2688, 384, 96, 3584, 512, 128)
    with pytest.raises(ValueError, match="bad shapes"):
        geometry(q, cache[..., :32], cache)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        geometry(q.half(), cache.half(), cache.half())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        geometry(torch.zeros((1, 2, 3, 64)), torch.zeros((1, 2, 2, 64)),
                 torch.zeros((1, 2, 2, 64)))
    with pytest.raises(ValueError, match="D <= 256"):
        geometry(*(torch.zeros((1, 2, 1, 257)),) * 3)
    with pytest.raises(ValueError, match="contiguous last"):
        t = torch.zeros((1, 2, 1, 128))[..., ::2]
        geometry(t, t, t)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 4, 1, 16))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(x, x, x, 0.25, True)
    assert flash_attention_cuda.launches == before
    # the dispatch takes the plain version for CPU tensors, not the kernel
    flash_attention(x[:, :, 0], x[:, :, 0], x[:, :, 0])
    flash_attention_gqa(x, x, x, 0.25)
    assert flash_attention_cuda.launches == before
