"""deepseek-v2 at its published MLA widths, on the CPU, against the JAX
package.

deepseek-v2-236b's attention is kept as published (``kv_lora_rank`` 512,
``q_lora_rank`` 1,536, keys 128 + 64 wide, values 128); ``d_model``, the
heads, the experts' width and the vocabulary are narrowed as
``ModelConfig.reduced()`` narrows them (64, 4, 64, 256), with 8 experts,
top-6 and both shared experts behind the dense prefix layer. The same JAX
weights cross with ``params_from_jax``. Serving is held as
``tests/test_torch_moe.py``'s ``SERVE_CASES`` hold it: logits and caches
within rtol 1e-5 (float32) or 2e-2 (bfloat16), with an atol of that times
the largest value. ``reduced()`` alone cuts the latent rank to 32, under
the kernels' old limit of 256, so these cases are the ones that reach the
latent decode at rank 512.

The kernels' plain versions at these widths: the tensor-core tile's twin
at the (192, 128) pair and both latent decode twins at 512 + 64 against
``sdpa``, and the dispatch that sends bfloat16 to the tensor-core kernels
there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import api as J
from repro.models.attention import causal_mask as j_causal_mask
from repro.models.attention import sdpa as j_sdpa
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ref
from repro_torch.models import api

NAME = "deepseek-v2-236b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}     # tests/test_torch_moe.py
# deepseek-v2's published MLA widths (src/repro/configs/deepseek_v2_236b.py)
MLA_WIDTHS = dict(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128)
MOE = dict(n_experts=8, top_k=6, n_shared_experts=2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, err_msg=""):
    want = _f32(want)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _models(dtype, seed=0, **kw):
    jcfg = J_ARCHS[NAME].reduced(dtype=dtype, **MLA_WIDTHS, **MOE, **kw)
    cfg = ARCHS[NAME].reduced(dtype=dtype, **MLA_WIDTHS, **MOE, **kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def _cache_leaves(caches) -> dict:
    if isinstance(next(iter(T.leaves(caches))), torch.Tensor):
        caches = api.caches_to_numpy(caches)
    return dict(T.leaves_with_paths(jax.tree.map(np.asarray, caches)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_match_jax_at_rank_512(dtype):
    """Prefill of a (2, 12) prompt, then 4 absorbed decode steps from zero
    caches fed the prompt's tokens, at the published MLA widths: logits at
    each step and the latent caches (512 + 64 wide) against JAX's
    ``mla_forward`` / ``mla_decode``. In bfloat16 the decode is held
    against JAX's decode in float32 on the same bfloat16 weights: JAX's own
    bfloat16 absorbed decode rounds its scores to bfloat16 (ROADMAP C24),
    which over a 512-wide latent moves its logits past 2e-2 of the largest
    (``test_jax_bf16_decode_rounds_its_scores_at_rank_512``)."""
    jcfg, cfg, jparams, params = _models(dtype)
    assert cfg.kv_lora_rank == 512 and cfg.decode_absorb
    assert len(params["prefix"]) == 1 and "shared" in params["layers"]["moe"]
    jt, tt = _tokens(cfg, 2, 12, 1)
    jl, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    _close(pl, jl, dtype, "prefill logits")
    if dtype == "bfloat16":          # JAX's decode in float32 (C24)
        jcfg = dataclasses.replace(jcfg, dtype="float32")
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                               jparams)
    jstep = jax.jit(J.decode_fn(jcfg))
    jcache = J.init_caches(jcfg, 2, 16)
    cache = api.init_caches(cfg, 2, 16, "cpu")
    for t in range(4):
        jlog, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.int32(t))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
        assert out is cache
        _close(log, jlog, dtype, f"decode logits, step {t}")
    for what, got, want in (("prefill", pc, jc), ("decode", cache, jcache)):
        g, w = _cache_leaves(got), _cache_leaves(want)
        assert sorted(g) == sorted(w) == [
            "layers/ckv", "layers/kr", "prefix/0/ckv", "prefix/0/kr"]
        for k in w:
            assert g[k].shape == w[k].shape and g[k].shape[-1] in (512, 64)
            _close(torch.from_numpy(np.asarray(g[k], np.float32)), w[k],
                   dtype, f"{what} {k}")


def test_jax_bf16_decode_rounds_its_scores_at_rank_512():
    """ROADMAP C24 at deepseek-v2's widths: against JAX's decode in float32
    on the same bfloat16 weights and tokens, JAX's bfloat16 absorbed decode
    (scores and weights rounded to bfloat16) strays past 2e-2 of the
    largest logit at some step of 4, the port's bfloat16 decode (float32
    scores, the weights rounded once) stays within it at every step."""
    jcfg, cfg, jparams, params = _models("bfloat16")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    jp32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    jt, tt = _tokens(cfg, 2, 12, 1)
    steps = {"jax": (jax.jit(J.decode_fn(jcfg)), J.init_caches(jcfg, 2, 16)),
             "f32": (jax.jit(J.decode_fn(jcfg32)),
                     J.init_caches(jcfg32, 2, 16))}
    cache = api.init_caches(cfg, 2, 16, "cpu")
    worst = {"jax": 0.0, "port": 0.0}
    for t in range(4):
        out = {}
        for k, (fn, c) in steps.items():
            out[k], c = fn(jparams if k == "jax" else jp32, c,
                           jt[:, t:t + 1], jnp.int32(t))
            steps[k] = (fn, c)
        with torch.no_grad():
            log, cache = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
        want = _f32(out["f32"])
        scale = float(np.abs(want).max())
        for k, got in (("jax", _f32(out["jax"])), ("port", _f32(log))):
            worst[k] = max(worst[k], float(np.abs(got - want).max()) / scale)
    assert worst["jax"] > TOL["bfloat16"] > worst["port"], worst


def test_absorbed_decode_equals_materialised_at_rank_512():
    """float32: the absorbed decode (q_nope W_uk against the 512-wide
    latent, the latent decode's plain version) and the materialised one
    (k_nope and v from the cache, the split decode's) give the same logits
    within rtol 1e-5, 6 steps after a prefill of 10."""
    _, cfg, _, params = _models("float32", seed=2)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)))
    logits = {}
    for absorb in (True, False):
        c = dataclasses.replace(cfg, decode_absorb=absorb)
        cache = api.init_caches(c, 2, 16, "cpu")
        with torch.no_grad():
            _, pre = api.prefill_fn(c)(params, {"tokens": toks[:, :10]})
            for k in ("ckv", "kr"):
                cache["prefix"][0][k][:, :10] = pre["prefix"][0][k]
                cache["layers"][k][:, :, :10] = pre["layers"][k]
            out = []
            for s in range(10, 16):
                lg, cache = api.decode_fn(c)(params, cache,
                                             toks[:, s:s + 1], s)
                out.append(lg)
        logits[absorb] = torch.cat(out, 1)
    _close(logits[True], logits[False], "float32", "absorbed vs materialised")


def _latent(rng, b, n, h, r=512, rd=64):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((b, 1, h, r), (b, 1, h, rd), (b, n, r), (b, n, rd))]


@pytest.mark.parametrize("b,n,h", [(1, 1, 128), (2, 300, 4), (1, 2100, 16)])
def test_latent_twins_at_rank_512_equal_sdpa(b, n, h):
    """Both latent decode twins at 512 + 64 against ``sdpa`` over one
    576-wide key head (values its first 512 columns), each with the splits
    its kernel takes: the CUDA-core kernel's in float32 within 1e-5, the
    tensor-core kernel's on bfloat16 inputs within the derived ``FLASH_TC``
    limit of the float32 ``sdpa`` (it rounds the weights to bfloat16: 2^-8
    |want| + (2^-8 + 2^-15) A + 2^-15, A the attention over |ckv|)."""
    xs = _latent(np.random.default_rng(n + h), b, n, h)
    scale = (128 + 64) ** -0.5
    keys = ref.mla_keys(xs[2], xs[3])
    want = ref.sdpa(torch.cat(xs[:2], -1), keys, xs[2][:, :, None], None,
                    scale)
    got = ref.flash_mla_decode_torch(*xs, scale,
                                     FA.mla_splits(b, h, n, 512))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    bf = [x.bfloat16() for x in xs]
    f = [x.float() for x in bf]
    want = ref.sdpa(torch.cat(f[:2], -1), ref.mla_keys(f[2], f[3]),
                    f[2][:, :, None], None, scale)
    a32 = ref.sdpa(torch.cat(f[:2], -1), ref.mla_keys(f[2], f[3]),
                   f[2].abs()[:, :, None], None, scale)
    twin = ref.flash_mla_decode_tc_torch(*bf, scale,
                                         FA.mla_tc_splits(b, h, n))
    lim = (2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a32
           + 2.0 ** -15)
    assert float(((twin.float() - want).abs() / lim).max()) <= 1.0


def test_latent_column_fault_exceeds_the_limit():
    """What a tensor-core kernel writing its first warpgroup's 256 columns
    over O's columns 256-511 would compute fails the limit the twin
    meets."""
    xs = _latent(np.random.default_rng(5), 1, 500, 64)
    f = [x.bfloat16().float() for x in xs]
    scale = 192 ** -0.5
    want = ref.sdpa(torch.cat(f[:2], -1), ref.mla_keys(f[2], f[3]),
                    f[2][:, :, None], None, scale)
    a32 = ref.sdpa(torch.cat(f[:2], -1), ref.mla_keys(f[2], f[3]),
                   f[2].abs()[:, :, None], None, scale)
    bad = torch.cat([want[..., :256], want[..., :256]], -1).bfloat16()
    lim = (2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a32
           + 2.0 ** -15)
    assert float(((bad.float() - want).abs() / lim).max()) > 1.0


@pytest.mark.parametrize("t,s,causal", [(130, 130, True), (37, 101, False),
                                        (300, 200, True)])
def test_tc_twin_at_192_128_against_jax(t, s, causal):
    """The tensor-core tile's twin at deepseek-v2's prefill pair (keys 192
    wide, values 128) within the derived ``FLASH_TC`` limit of the float32
    plain version and within the JAX tests' 3e-2 of the JAX model's
    ``sdpa``."""
    rng = np.random.default_rng(t + s)
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)
    q, k, v = mk(2, t, 4, 192), mk(2, s, 2, 192), mk(2, s, 2, 128)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    scale = 192 ** -0.5
    got = ref.flash_attention_tc_torch(tq, tk, tv, scale, causal)
    assert got.shape == (2, t, 4, 128)
    f = [x.float() for x in (tq, tk, tv)]
    want = ref.flash_attention_gqa_torch(*f, scale, causal)
    a32 = ref.flash_attention_gqa_torch(f[0], f[1], f[2].abs(), scale,
                                        causal)
    lim = (2.0 ** -8 * want.abs() + (2.0 ** -8 + 2.0 ** -15) * a32
           + 2.0 ** -15)
    assert float(((got.float() - want).abs() / lim).max()) <= 1.0
    jmask = (j_causal_mask(t, s)[None] if causal
             else jnp.ones((1, t, s), bool))
    jwant = j_sdpa(*(jnp.asarray(x.numpy()) for x in f), jmask,
                   jnp.float32(scale))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jwant, np.float32), rtol=3e-2,
                               atol=3e-2)


def test_dispatch_at_deepseek_widths():
    """bfloat16 prefill at (192, 128) takes the tensor-core tile, float32
    the CUDA-core one; bfloat16 latent decode at 512 + 64 (and + 32) the
    tensor-core kernel with its splits; r 320 and float32 the CUDA-core
    kernel, 32 heads a block past r 256."""
    bf = torch.bfloat16
    assert (192, 128) in FA.TC_DIMS
    assert FA.path_of(torch.zeros(1, 9, 4, 192, dtype=bf), 128) == "tile_tc"
    assert FA.path_of(torch.zeros(1, 9, 4, 192), 128) == "tile_simt"
    assert FA.path_of(torch.zeros(1, 9, 4, 192, dtype=bf)) == "tile_simt"
    for r, rd, dt, want in ((512, 64, bf, "mla_decode_tc"),
                            (512, 32, bf, "mla_decode_tc"),
                            (320, 64, bf, "mla_decode"),
                            (512, 64, torch.float32, "mla_decode")):
        ql, qr = torch.zeros(1, 1, 128, r, dtype=dt), torch.zeros(
            1, 1, 128, rd, dtype=dt)
        assert FA.mla_path_of(ql, qr) == want
        splits = (FA.mla_tc_splits(1, 128, 32_832) if want == "mla_decode_tc"
                  else FA.decode_splits(32_832, 128 // FA.MLA_WIDE_HEADS))
        assert FA.mla_splits_of(ql, qr, 32_832) == splits
    # one wave: 2 head groups x 66 splits at deepseek-v2's decode_32k cell
    assert FA.mla_tc_splits(1, 128, 32_832) == 66
    assert FA.mla_heads(256) == FA.MLA_HEADS == 40
    assert FA.mla_heads(264) == FA.mla_heads(512) == FA.MLA_WIDE_HEADS == 32


def test_launcher_refuses_past_its_widths_and_cpu_tensors():
    """The kernels' launcher takes r up to 512 and refuses more, and
    refuses CPU tensors without counting; the plain version computes at
    any widths."""
    xs = _latent(np.random.default_rng(0), 1, 5, 4, r=520)
    with pytest.raises(ValueError, match="r <= 512"):
        FA.mla_geometry(*xs)
    ok = _latent(np.random.default_rng(0), 1, 5, 4)
    assert FA.mla_geometry(*ok) == (1, 5, 4, 512, 64)
    before = dict(FA.flash_attention_cuda.launches_by_path)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_mla_decode_cuda(*ok, 0.1)
    assert FA.flash_attention_cuda.launches_by_path == before
    from repro_torch.kernels.flash_attention.ops import flash_mla_decode
    assert flash_mla_decode(*xs, 0.1).shape == (1, 1, 4, 520)
