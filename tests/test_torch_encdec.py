"""The port's encoder-decoder (whisper, ``models/encdec.py``) on the CPU vs
the JAX package's.

The JAX model's parameters (``api.init_fn``) cross to the port with
``params_from_jax``; the same numpy frames and tokens go through the JAX
``encode``/``loss_fn``/``prefill``/``decode_step`` and the port's. The JAX
module reaches no Pallas kernel (its ``_attend`` is jnp ``sdpa``); on CPU
tensors the port's prefill and decode run the flash kernel's plain
version. Tolerances: float32 rtol 1e-5, bfloat16 rtol 2e-2, each with an
atol of the same factor times the largest reference value (summation
order; bfloat16 rounds at other places in the two frameworks), as
``tests/test_torch_serve.py``; every gradient leaf is held the same way,
against its own largest value.

JAX's ``prefill`` returns self caches T slots long, and its
``decode_step`` would clamp a write at ``pos = T`` into slot T - 1 (ROADMAP
C26): both sides decode from caches handed over into ``init_caches``' 448
self slots at [0, T), the cross caches as the prefill made them; the
port's by ``api.decode_caches``, the JAX side's built here, in the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import api as J
from repro.models import encdec as J_encdec
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import api, encdec

NAME = "whisper-large-v3"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


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
    jcfg = J_ARCHS[NAME].reduced(dtype=dtype, **kw)
    cfg = ARCHS[NAME].reduced(dtype=dtype, **kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, b, s, t, seed, labels=False):
    """frames (b, s, d) float32 (the model casts them) and t tokens, as
    (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(b, t + 1)).astype(np.int32)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :-1])}
    tb = {"frames": torch.as_tensor(frames),
          "tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int64)}
    if labels:
        jb["labels"] = jnp.asarray(toks[:, 1:])
        tb["labels"] = torch.as_tensor(toks[:, 1:], dtype=torch.int64)
    return jb, tb


def _leaves(tree) -> dict:
    if isinstance(next(iter(T.leaves(tree))), torch.Tensor):
        tree = api.caches_to_numpy(tree)
    return dict(T.leaves_with_paths(jax.tree.map(np.asarray, tree)))


def _jax_handoff(jcfg, jcaches, b, s, t):
    """JAX's prefill caches in decode caches: self k/v at [0, t) of the
    448 slots, the cross caches as they are."""
    dec = J_encdec.init_caches(jcfg, b, s)["dec"]
    self_ = {n: dec["self"][n].at[:, :, :t].set(jcaches["dec"]["self"][n])
             for n in ("k", "v")}
    return {"dec": {"self": self_, "cross": jcaches["dec"]["cross"]}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(448, 1280), (1500, 1280), (37, 64)])
def test_sinusoid_is_bitwise_jax(t, d, dtype):
    got = encdec.sinusoid(t, d, getattr(torch, dtype))
    want = J_encdec.sinusoid(t, d, jnp.dtype(dtype))
    assert tuple(got.shape) == want.shape == (t, d)
    assert np.array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(dtype):
    """The encoder's output, in train mode (``sdpa``) and prefill mode (the
    flash kernel's plain version, non-causal)."""
    jcfg, cfg, jparams, params = _models(dtype)
    jb, tb = _batch(cfg, 2, 40, 4, 1)
    want = J_encdec.encode(jparams, jb["frames"], jcfg)
    with torch.no_grad():
        for mode in ("train", "prefill"):
            got = encdec.encode(params, tb["frames"], cfg, mode)
            assert got.dtype == getattr(torch, dtype)
            _close(got, want, dtype, f"encode ({mode})")


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_jax(dtype):
    jcfg, cfg, jparams, params = _models(dtype)
    jb, tb = _batch(cfg, 2, 24, 10, 2, labels=True)
    tb["labels"][0, 3] = -1              # a masked label
    jb["labels"] = jb["labels"].at[0, 3].set(-1)
    (jloss, jmet), jgrads = jax.value_and_grad(J.loss_fn(jcfg),
                                               has_aux=True)(jparams, jb)
    loss, met = api.loss_fn(cfg)(params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=TOL[dtype])
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    named = list(T.leaves_with_paths(params))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(k for k, _ in named)
    for (k, _), g in zip(named, grads):
        jg = _f32(jflat[k])
        assert tuple(g.shape) == jg.shape, k
        _close(g, jg, dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_caches_match_jax(dtype):
    jcfg, cfg, jparams, params = _models(dtype)
    jb, tb = _batch(cfg, 2, 30, 8, 3)
    jl, jc = J.prefill_fn(jcfg)(jparams, jb)
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, tb)
    assert pl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, dtype, "prefill logits")
    got, want = _leaves(pc), _leaves(jc)
    assert sorted(got) == sorted(want) == [
        "dec/cross/k", "dec/cross/v", "dec/self/k", "dec/self/v"]
    assert want["dec/self/k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                        cfg.hd)
    assert want["dec/cross/k"].shape[2] == 30
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        _close(torch.from_numpy(np.asarray(got[k], np.float32)), want[k],
               dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_from_handed_off_caches_matches_jax(dtype):
    """8 decode steps fed the same tokens from the prefill's caches handed
    over into 448 self slots: the logits at each step and the caches
    after them."""
    jcfg, cfg, jparams, params = _models(dtype)
    b, s, t = 2, 30, 5
    jb, tb = _batch(cfg, b, s, t, 4)
    _, jc = J.prefill_fn(jcfg)(jparams, jb)
    with torch.no_grad():
        _, pc = api.prefill_fn(cfg)(params, tb)
    jcache = _jax_handoff(jcfg, jc, b, s, t)
    cache = api.decode_caches(cfg, pc, tb, 8)
    assert cache["dec"]["cross"] is pc["dec"]["cross"]     # no copy
    cross = cache["dec"]["cross"]["k"].data_ptr()
    feed = np.random.default_rng(5).integers(0, cfg.vocab, (b, 8))
    jstep = jax.jit(J.decode_fn(jcfg))
    for i in range(8):
        jtok = jnp.asarray(feed[:, i:i + 1], jnp.int32)
        jlog, jcache = jstep(jparams, jcache, jtok, jnp.int32(t + i))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache,
                                          torch.as_tensor(feed[:, i:i + 1]),
                                          t + i)
        assert out is cache and log.shape == (b, 1, cfg.padded_vocab)
        _close(log, jlog, dtype, f"decode logits, step {i}")
    assert cache["dec"]["cross"]["k"].data_ptr() == cross
    got, want = _leaves(cache), _leaves(jcache)
    for k in want:
        _close(torch.from_numpy(np.asarray(got[k], np.float32)), want[k],
               dtype, f"decode {k}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_tokens_equal_jax(dtype):
    """``make_prefill_step`` and 8 ``make_serve_step``s against the JAX
    steps' greedy loop over the same handed-off caches: equal tokens."""
    from repro.launch import steps as J_steps
    jcfg, cfg, jparams, params = _models(dtype)
    b, s, t = 2, 30, 8
    jb, tb = _batch(cfg, b, s, t, 6)
    jtok, jc = J_steps.make_prefill_step(jcfg)(jparams, jb)
    tok, pc = steps.make_prefill_step(cfg)(params, tb)
    jcache = _jax_handoff(jcfg, jc, b, s, t)
    cache = api.decode_caches(cfg, pc, tb, 8)
    jserve = jax.jit(J_steps.make_serve_step(jcfg))
    serve = steps.make_serve_step(cfg)
    jtoks, toks = [np.asarray(jtok)], [tok.numpy()]
    for i in range(8):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(t + i))
        tok, cache = serve(params, cache, tok, t + i)
        jtoks.append(np.asarray(jtok))
        toks.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))


def test_padded_vocab_is_never_chosen():
    """A vocab of 250 pads to 256: the last 6 columns of every prefill and
    decode logit hold -1e30 on both sides, and no greedy token lands
    there."""
    jcfg, cfg, jparams, params = _models("float32", vocab=250)
    assert cfg.padded_vocab == 256
    b, s, t = 2, 20, 4
    jb, tb = _batch(cfg, b, s, t, 7)
    jl, _ = J.prefill_fn(jcfg)(jparams, jb)
    assert (np.asarray(jl)[..., 250:] == -1e30).all()
    with torch.no_grad():
        log, pc = api.prefill_fn(cfg)(params, tb)
        cache = api.decode_caches(cfg, pc, tb, 9)
        toks = []
        for i in range(9):
            assert (_f32(log)[..., 250:] == np.float32(-1e30)).all()
            toks.append(steps._greedy(log))
            log, _ = api.decode_fn(cfg)(params, cache, toks[-1], t + i)
    assert int(torch.cat(toks, 1).max()) < 250


def test_remat_is_bitwise_no_remat():
    """``cfg.remat`` checkpoints every encoder and decoder layer: the loss
    and every gradient leaf equal the run without it, bit for bit."""
    cfg = ARCHS[NAME].reduced(dtype="float32")
    _, tb = _batch(cfg, 2, 24, 10, 8, labels=True)
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = api.init_fn(c, "cpu")(0)
        loss, _ = api.loss_fn(c)(params, tb)
        named = list(T.leaves_with_paths(params))
        out.append((loss, torch.autograd.grad(loss, [p for _, p in named])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_and_caches_round_trip_bitwise(dtype):
    """JAX's stacked ``enc_layers``/``dec_layers`` and its ``{"dec":
    {"self", "cross"}}`` caches cross to the port and back leaf for leaf,
    bit for bit; the port's own init has the JAX tree's keys, shapes and
    dtypes."""
    jcfg, cfg, jparams, params = _models(dtype)
    jflat = _leaves(jparams)
    back = _leaves(api.params_to_numpy(params))
    assert sorted(back) == sorted(jflat)
    for k, a in jflat.items():
        assert back[k].shape == a.shape and back[k].dtype == a.dtype, k
        assert np.array_equal(back[k].view(np.uint8), a.view(np.uint8)), k
    own = dict(T.leaves_with_paths(api.init_fn(cfg, "cpu")(0)))
    assert sorted(own) == sorted(jflat)
    for k, p in own.items():
        assert tuple(p.shape) == jflat[k].shape and p.requires_grad, k
        assert str(p.dtype)[6:] == str(jflat[k].dtype), k
    jb, _ = _batch(cfg, 2, 12, 4, 9)
    _, jc = J.prefill_fn(jcfg)(jparams, jb)
    caches = api.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert not caches["dec"]["cross"]["k"].requires_grad
    back = _leaves(caches)
    for k, a in _leaves(jc).items():
        assert back[k].dtype == a.dtype
        assert np.array_equal(back[k].view(np.uint8), a.view(np.uint8)), k
    zero = _leaves(api.init_caches(cfg, 2, 12, "cpu"))
    for k, a in _leaves(J.init_caches(jcfg, 2, 12)).items():
        assert zero[k].shape == a.shape and zero[k].dtype == a.dtype, k


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_jax(shape, mode):
    """At the published config, without allocating: the port's batch on
    the meta device against ``jax.eval_shape`` of JAX's."""
    spec = api.SHAPES[shape]
    want = jax.eval_shape(lambda: J.input_specs(J_ARCHS[NAME],
                                                J.SHAPES[shape], mode))
    got = api.input_specs(ARCHS[NAME], spec, mode, device="meta")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        if k == "frames":
            assert got[k].dtype == torch.bfloat16 == encdec.dtype_of(
                ARCHS[NAME])
    assert got["tokens"].shape[1] == (
        min(max(8, spec.seq_len // 8), 448) if mode == "train" else 8)


def test_decode_writes_in_place_and_stops_at_448():
    """A decode step writes the token's k/v at ``pos`` into the caches it
    was given (no new cache) and refuses a position past the 448 self
    slots, which JAX would clamp."""
    _, cfg, _, params = _models("float32")
    cache = api.init_caches(cfg, 1, 6, "cpu")
    ptrs = [x.data_ptr() for x in T.leaves(cache)]
    tok = torch.zeros((1, 1), dtype=torch.int64)
    with torch.no_grad():
        _, out = api.decode_fn(cfg)(params, cache, tok, 447)
        assert out is cache and [x.data_ptr() for x in T.leaves(out)] == ptrs
        assert cache["dec"]["self"]["k"][:, :, 447].abs().sum() > 0
        assert cache["dec"]["self"]["k"][:, :, :447].abs().sum() == 0
        with pytest.raises(ValueError, match="448"):
            api.decode_fn(cfg)(params, cache, tok, 448)


def test_serving_takes_flash_and_training_sdpa(monkeypatch):
    """Prefill and decode run the flash kernel's dispatch, the encoder and
    cross attention non-causal, the decoder's self-attention causal;
    training never calls it."""
    _, cfg, _, params = _models("float32")
    calls = []
    real = encdec.flash_attention_gqa

    def spy(q, k, v, scale, causal=True, window=0):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, scale, causal, window)

    monkeypatch.setattr(encdec, "flash_attention_gqa", spy)
    _, tb = _batch(cfg, 2, 16, 4, 10, labels=True)
    api.loss_fn(cfg)(params, tb)
    assert calls == []
    with torch.no_grad():
        _, pc = api.prefill_fn(cfg)(params, tb)
        L = cfg.n_layers
        assert calls == ([(16, 16, False)] * cfg.n_encoder_layers
                         + [(4, 4, True), (4, 16, False)] * L)
        calls.clear()
        api.decode_fn(cfg)(params, api.decode_caches(cfg, pc, tb, 1),
                           tb["tokens"][:, :1], 4)
    assert calls == [(1, 5, False), (1, 16, False)] * L


def test_position_tables_are_built_once_per_function(monkeypatch):
    """Each ``api`` function of the encoder-decoder builds a position table
    on its first call that needs it and keeps it (JAX's jit folds the
    table into a constant): a second prefill, decode step or loss of the
    same function builds none; a new function builds its own."""
    cfg = ARCHS[NAME].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    built = []
    real = encdec.sinusoid

    def spy(T, d, dtype, device="cpu"):
        built.append(T)
        return real(T, d, dtype, device)

    monkeypatch.setattr(encdec, "sinusoid", spy)
    _, tb = _batch(cfg, 2, 24, 6, 11, labels=True)
    pfn, dfn, lfn = (api.prefill_fn(cfg), api.decode_fn(cfg),
                     api.loss_fn(cfg))
    with torch.no_grad():
        _, pc = pfn(params, tb)
        assert built == [24, 6]
        pfn(params, tb)
        assert built == [24, 6]
        cache = api.decode_caches(cfg, pc, tb, 2)
        for i in range(2):
            dfn(params, cache, tb["tokens"][:, :1], 6 + i)
        assert built == [24, 6, encdec.WHISPER_MAX_TARGET]
        lfn(params, tb)
        lfn(params, tb)
        assert built == [24, 6, encdec.WHISPER_MAX_TARGET, 24, 6]
        api.prefill_fn(cfg)(params, tb)
    assert built[5:] == [24, 6]
