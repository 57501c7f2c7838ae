"""The port's serving path on the CPU vs the JAX package's.

The JAX model's parameters (``api.init_fn``) cross to the port with
``params_from_jax``, the same numpy prompts go through the JAX
``prefill_fn``/``decode_fn`` and the port's, and the last logits and every
cache leaf are compared. Float32 is held to rtol 1e-5 with an atol of 1e-5
times the largest reference value (summation order; entries near zero have
no relative precision); bfloat16 to rtol 2e-2 with an atol of 2e-2 times
the largest value, as ``tests/test_torch_model.py`` holds the train
forward (8-bit mantissas, rounded at other places in the two frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as J_steps
from repro.models import api as J
from repro.models import attention as J_attn
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import api, attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


def _models(name, dtype, seed=0):
    jcfg = J_ARCHS[name].reduced(dtype=dtype)
    cfg = ARCHS[name].reduced(dtype=dtype)
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


def _close_caches(got, want, dtype, what):
    g, w = _cache_leaves(got), _cache_leaves(want)
    assert sorted(g) == sorted(w) == ["layers/k", "layers/v"], (g, w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        _close(torch.from_numpy(np.asarray(g[k], np.float32)), w[k], dtype,
               f"{what} {k}")


CASES = [("qwen3-32b", "float32"),        # qk-norm, swiglu, 4 heads over 2
         ("granite-20b", "float32"),      # MQA (kv = 1), gelu
         ("nemotron-4-340b", "float32"),  # relu2
         ("qwen3-32b", "bfloat16")]


@pytest.mark.parametrize("name,dtype", CASES)
def test_prefill_then_decode_match_jax(name, dtype):
    """Prefill of a (2, 12) prompt, then 8 decode steps from zero caches
    fed the prompt's tokens: logits and caches against JAX at each step."""
    jcfg, cfg, jparams, params = _models(name, dtype)
    jt, tt = _tokens(cfg, 2, 12, 1)
    jl, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    assert pl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, dtype, "prefill logits")
    _close_caches(pc, jc, dtype, "prefill")
    assert pc["prefix"] == []

    jstep = jax.jit(J.decode_fn(jcfg))
    jcache = J.init_caches(jcfg, 2, 16)
    cache = api.init_caches(cfg, 2, 16, "cpu")
    assert api.caches_to_numpy(cache)["layers"]["k"].shape == (
        cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.hd)
    for t in range(8):
        jlog, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.int32(t))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
        assert out is cache
        _close(log, jlog, dtype, f"decode logits, step {t}")
    _close_caches(cache, jcache, dtype, "decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_ring_buffer_matches_jax(dtype):
    """The sliding-window branch of ``gqa_decode`` (a ring of 8 slots) on
    its own, over 20 positions, so the ring wraps twice."""
    jcfg = J_ARCHS["qwen3-32b"].reduced(dtype=dtype)
    cfg = ARCHS["qwen3-32b"].reduced(dtype=dtype)
    jp = J_attn.init_gqa(jax.random.PRNGKey(4), jcfg)
    p = api.caches_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jcache = J_attn.gqa_cache_spec(jcfg, 2, 64, window=8)
    cache = attention.gqa_cache_spec(cfg, 2, 64, window=8, device="cpu")
    assert cache["k"].shape == jcache["k"].shape == (2, 8, 2, 16)
    rng = np.random.default_rng(4)
    jdec = jax.jit(J_attn.gqa_decode, static_argnums=(4, 5))
    for pos in range(20):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jdec(jp, jnp.asarray(x, jcfg.dtype), jcache,
                            jnp.int32(pos), jcfg, 8)
        with torch.no_grad():
            out, back = attention.gqa_decode(
                p, torch.from_numpy(x).to(getattr(torch, dtype)), cache, pos,
                cfg, window=8)
        assert back is cache
        _close(out, jout, dtype, f"position {pos}")
    _close_caches({"layers": cache}, {"layers": jcache}, dtype, "ring")


def test_gqa_decode_refuses_a_position_past_the_cache():
    cfg = ARCHS["qwen3-32b"].reduced(dtype="float32")
    p = api.init_fn(cfg, "cpu")(0)
    cache = attention.gqa_cache_spec(cfg, 1, 4, device="cpu")
    block = {k: v[0] for k, v in p["layers"]["attn"].items()}
    with pytest.raises(ValueError, match="outside a cache of 4"):
        attention.gqa_decode(block, torch.zeros((1, 1, cfg.d_model)), cache,
                             4, cfg)


@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2),
                                        ("float32", 1e-5)])
def test_decode_matches_prefill_logits(dtype, atol):
    """The port's twin of ``test_decode_matches_prefill_logits``: decoding
    token t from the caches reproduces the prefill's logits (bfloat16 at
    the JAX test's atol 2e-2; float32 at 1e-5)."""
    cfg = ARCHS["qwen3-32b"].reduced(dtype=dtype)
    params = api.init_fn(cfg, "cpu")(2)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 8)))
    with torch.no_grad():
        logits_p, _ = api.prefill_fn(cfg)(params, {"tokens": toks})
        caches = api.init_caches(cfg, 1, 16, "cpu")
        for t in range(8):
            out, caches = api.decode_fn(cfg)(params, caches,
                                             toks[:, t:t + 1], t)
    np.testing.assert_allclose(_f32(out[:, 0]), _f32(logits_p[:, 0]),
                               atol=atol)


@pytest.mark.parametrize("name", ["qwen3-32b", "granite-20b"])
def test_greedy_steps_match_jax_launch_steps(name):
    """``make_prefill_step`` then 8 ``make_serve_step``s, float32: the same
    greedy tokens as JAX's ``launch/steps.py``, the prefill caches copied
    into decode caches of 20 positions."""
    jcfg, cfg, jparams, params = _models(name, "float32", seed=5)
    jt, tt = _tokens(cfg, 2, 10, 6)
    jtok, jc = jax.jit(J_steps.make_prefill_step(jcfg))(jparams,
                                                        {"tokens": jt})
    tok, pc = steps.make_prefill_step(cfg)(params, {"tokens": tt})
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    jcache = jax.tree.map(
        lambda z, c: jax.lax.dynamic_update_slice(z, c, (0,) * z.ndim),
        J.init_caches(jcfg, 2, 20), jc)
    cache = api.init_caches(cfg, 2, 20, "cpu")
    for k in ("k", "v"):
        cache["layers"][k][:, :, :10] = pc["layers"][k]
    jserve = jax.jit(J_steps.make_serve_step(jcfg))
    got, want = [tok], [jtok]
    for s in range(8):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(10 + s))
        tok, out = steps.make_serve_step(cfg)(params, cache, tok, 10 + s)
        assert out is cache
        got.append(tok)
        want.append(jtok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                  np.concatenate([np.asarray(w)
                                                  for w in want], 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caches_from_jax_round_trip(dtype):
    jcfg = J_ARCHS["qwen3-32b"].reduced(dtype=dtype)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(0))
    _, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jnp.ones((2, 6),
                                                            jnp.int32)})
    caches = api.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert caches["prefix"] == [] and not caches["layers"]["k"].requires_grad
    back = _cache_leaves(caches)
    for k, a in _cache_leaves(jc).items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      a.view(np.uint8), err_msg=k)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_config_serves_at_reduced_size(name):
    """Every config of the zoo passes ``init_fn`` and serves on the CPU at
    its reduced size through ``launch/steps.py``: a prefill of
    ``input_specs``' prefill batch (random tokens; a VLM's prefix
    embeddings, whisper's frames), its caches handed over by
    ``api.decode_caches`` (whisper's self k/v into its 448 slots, its
    cross caches as they are), 3 greedy steps from ``api.decode_start``
    on; tokens in the vocab, logits finite."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    batch = api.input_specs(cfg, api.ShapeSpec("s", 32, 2, "prefill"),
                            device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch["tokens"] = torch.randint(0, cfg.vocab, batch["tokens"].shape,
                                    generator=gen)
    for key in ("prefix_embeds", "frames"):
        if key in batch:
            batch[key] = torch.randn(batch[key].shape, generator=gen)
    tok, pre = steps.make_prefill_step(cfg)(params, batch)
    n = api.decode_start(batch)
    caches = api.decode_caches(cfg, pre, batch, 3)
    toks = [tok]
    for s in range(3):
        with torch.inference_mode():
            logits, out = api.decode_fn(cfg)(params, caches, tok, n + s)
        assert out is caches and torch.isfinite(logits[..., :cfg.vocab]).all()
        tok = steps._greedy(logits)
        toks.append(tok)
    toks = torch.cat(toks, 1)
    assert toks.shape == (2, 4) and 0 <= int(toks.min()) and \
        int(toks.max()) < cfg.vocab


@pytest.mark.parametrize("name", [
    "granite-20b", "qwen3-32b", "minicpm3-4b", "llava-next-34b",
    "hymba-1.5b", "whisper-large-v3"])
def test_decode_caches_continue_the_prefill(name):
    """``api.decode_caches`` hands a prefill over so that decoding goes on
    where it stopped: after 3 greedy steps from ``api.decode_start``, the
    last step's logits equal a fresh prefill's of the prompt extended by
    the 3 tokens the steps were fed (float32, rtol 1e-4 with an atol of 1e-4 times the
    largest logit). The MoE configs (a decode step routes other pairs than
    the prefill drops) and xLSTM (whole chunks only) are left out."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    batch = api.input_specs(cfg, api.ShapeSpec("s", 40, 2, "prefill"),
                            device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch["tokens"] = torch.randint(0, cfg.vocab, batch["tokens"].shape,
                                    generator=gen)
    for key in ("prefix_embeds", "frames"):
        if key in batch:
            batch[key] = torch.randn(batch[key].shape, generator=gen)
    tok, pre = steps.make_prefill_step(cfg)(params, batch)
    caches = api.decode_caches(cfg, pre, batch, 3)
    n, toks = api.decode_start(batch), [tok]
    for s in range(3):
        with torch.inference_mode():
            logits, _ = api.decode_fn(cfg)(params, caches, toks[-1], n + s)
        toks.append(steps._greedy(logits))
    seq = torch.cat([batch["tokens"]] + [t.long() for t in toks[:3]], 1)
    with torch.inference_mode():
        fresh, _ = api.prefill_fn(cfg)(params, dict(batch, tokens=seq))
    want = fresh[:, -1, :cfg.vocab]
    torch.testing.assert_close(logits[:, -1, :cfg.vocab], want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["qwen3-32b", "minicpm3-4b"])
def test_training_keeps_sdpa_and_serving_takes_flash(monkeypatch, name):
    """Train mode never calls the flash kernel's dispatch; prefill and
    decode never call ``sdpa``/``sdpa_blocked``. MLA's absorbed decode
    takes the latent decode (``flash_mla_decode``) instead."""
    cfg = ARCHS[name].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = []
    real = attention.flash_attention_gqa
    real_mla = attention.flash_mla_decode

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    def counted_mla(*a, **kw):
        calls.append(("mla", a[2].shape[1]))
        return real_mla(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("sdpa on the serving path")

    monkeypatch.setattr(attention, "flash_attention_gqa", counted)
    monkeypatch.setattr(attention, "flash_mla_decode", counted_mla)
    loss, _ = api.loss_fn(cfg)(params, batch)
    loss.backward()
    assert calls == []
    monkeypatch.setattr(attention, "sdpa", refuse)
    monkeypatch.setattr(attention, "sdpa_blocked", refuse)
    tok, caches = steps.make_prefill_step(cfg)(params, batch)
    cache = api.init_caches(cfg, 2, 9, "cpu")
    steps.make_serve_step(cfg)(params, cache, tok, 8)
    decode = [("mla", 9) if cfg.attn_type == "mla" else 1]
    assert calls == [8] * cfg.n_layers + decode * cfg.n_layers


def test_input_specs_and_cell_supported():
    cfg = ARCHS["qwen3-32b"].reduced()
    for name, shape in api.SHAPES.items():
        jok = J.cell_supported(J_ARCHS["qwen3-32b"], J.SHAPES[name])
        assert api.cell_supported(ARCHS["qwen3-32b"], shape) == jok
        small = api.ShapeSpec(name, 16, 2, shape.kind)
        batch = api.input_specs(cfg, small, device="cpu")
        jbatch = J.input_specs(J_ARCHS["qwen3-32b"].reduced(),
                               J.ShapeSpec(name, 16, 2, shape.kind))
        assert sorted(batch) == sorted(jbatch)
        for k, v in batch.items():
            assert tuple(v.shape) == jbatch[k].shape and not v.any(), k
