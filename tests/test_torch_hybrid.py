"""The port's hybrid family (hymba: attention and Mamba heads in every
block, sliding-window attention but on the global layers) on the CPU vs
the JAX package's.

The JAX model's parameters cross to the port with ``params_from_jax``
(the ``blocks`` list kept a list, in JAX's leaf order), the same numpy
prompts go through the JAX ``prefill_fn``/``decode_fn`` and
``launch/steps.py`` and the port's, and logits and every cache leaf are
compared at ``tests/test_torch_serve.py``'s tolerances: float32 rtol 1e-5
with an atol of 1e-5 times the largest reference value, bfloat16 2e-2 and
2e-2 times the largest value. The reduced hymba has 2 layers, layer 0
global and layer 1 windowed (32 positions); prompts of 40 and 44 tokens
cross the window, and decode runs past it, so the ring buffer wraps.

Prefill hands its caches to decode caches sized for the whole run as a
server would: a global layer's k/v into positions [0, T), a windowed
layer's last positions p into ring slot p % S, the Mamba state as it is.
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
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps
from repro_torch.models import api, attention, ssm, transformer

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


def _models(dtype, seed=0, **kw):
    jcfg = J_ARCHS["hymba-1.5b"].reduced(dtype=dtype, chunk_size=8, **kw)
    cfg = ARCHS["hymba-1.5b"].reduced(dtype=dtype, chunk_size=8, **kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def _leaves(caches) -> dict:
    if isinstance(next(iter(T.leaves(caches))), torch.Tensor):
        caches = api.caches_to_numpy(caches)
    return dict(T.leaves_with_paths(jax.tree.map(np.asarray, caches)))


def _close_caches(got, want, dtype, what):
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w), (list(g), list(w))
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        _close(torch.from_numpy(np.asarray(g[k], np.float32)), w[k], dtype,
               f"{what} {k}")


def handoff(pre, dec, t: int):
    """Copy prefill caches (a ``t``-token prompt) into decode caches of the
    same tree, in place: position p of a k/v of S slots goes to slot
    p % S for the last min(t, S) positions (a global layer: [0, t); a
    windowed ring: the last S), a Mamba state as it is. Works on numpy
    arrays and on torch tensors."""
    for pb, db in zip(pre["blocks"], dec["blocks"]):
        for n in ("k", "v"):
            s = db["attn"][n].shape[1]
            p = np.arange(max(0, t - s), t)
            db["attn"][n][:, p % s] = pb["attn"][n][:, p]
        db["ssm"]["s"][...] = pb["ssm"]["s"]
    return dec


def _jax_handoff(jpre, jcfg, b, t, seq):
    dec = jax.tree.map(lambda a: np.array(a), J.init_caches(jcfg, b, seq))
    handoff(jax.tree.map(np.asarray, jpre), dec, t)
    return jax.tree.map(jnp.asarray, dec)


@pytest.mark.parametrize("window", [1, 7, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_prefill_attention_matches_jax(window, dtype):
    """``gqa_forward(mode="prefill", window=w)`` (the flash dispatch with
    its window) against JAX's ``gqa_forward(window=w)`` (``sdpa`` under
    ``causal_mask(T, T, w)``), T = 40."""
    jcfg = J_ARCHS["hymba-1.5b"].reduced(dtype=dtype)
    cfg = ARCHS["hymba-1.5b"].reduced(dtype=dtype)
    jp = J_attn.init_gqa(jax.random.PRNGKey(window), jcfg)
    p = api.caches_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(window).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32)
    jout, jkv = J_attn.gqa_forward(jp, jnp.asarray(x, jcfg.dtype), jcfg,
                                   window=window)
    with torch.no_grad():
        out, kv = attention.gqa_forward(
            p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
            window=window, mode="prefill")
    _close(out, jout, dtype, "out")
    for n in ("k", "v"):
        _close(kv[n], jkv[n], dtype, n)


@pytest.mark.parametrize("t", [40, 44])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(t, dtype):
    """Last logits and every cache leaf (k/v of both layers, both Mamba
    states); T = 44 is not a multiple of the chunk (JAX takes its
    sequential scan there, the port the same kernel)."""
    jcfg, cfg, jparams, params = _models(dtype)
    jt, tt = _tokens(cfg, 2, t, t)
    jl, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    assert pl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, dtype, "prefill logits")
    _close_caches(pc, jc, dtype, "prefill")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_past_the_window_matches_jax(dtype):
    """Prefill of 40 tokens handed to caches of 72 positions (the windowed
    layer's ring of 32 slots), then 30 teacher-forced decode steps, so the
    ring wraps again at position 64: logits at every step and every cache
    leaf at the end against JAX, caches written in place."""
    jcfg, cfg, jparams, params = _models(dtype, seed=1)
    jt, tt = _tokens(cfg, 2, 70, 2)
    _, jpre = J.prefill_fn(jcfg)(jparams, {"tokens": jt[:, :40]})
    with torch.no_grad():
        _, pre = api.prefill_fn(cfg)(params, {"tokens": tt[:, :40]})
    jcache = _jax_handoff(jpre, jcfg, 2, 40, 72)
    cache = api.init_caches(cfg, 2, 72, "cpu")
    assert [tuple(b["attn"]["k"].shape) for b in cache["blocks"]] == [
        (2, 72, 2, 16), (2, 32, 2, 16)]
    with torch.no_grad():
        handoff(pre, cache, 40)
    _close_caches(cache, jcache, dtype, "handoff")
    ptrs = [leaf.data_ptr() for leaf in T.leaves(cache)]
    jstep = jax.jit(J.decode_fn(jcfg))
    for pos in range(40, 70):
        jlog, jcache = jstep(jparams, jcache, jt[:, pos:pos + 1],
                             jnp.int32(pos))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache, tt[:, pos:pos + 1],
                                          pos)
        assert out is cache
        _close(log, jlog, dtype, f"decode logits, position {pos}")
    assert [leaf.data_ptr() for leaf in T.leaves(cache)] == ptrs
    _close_caches(cache, jcache, dtype, "decode")


def test_greedy_steps_match_jax_launch_steps():
    """``make_prefill_step`` then 8 ``make_serve_step``s, float32, a prompt
    of 28 so decode crosses the window of 32 at position 32: the same
    greedy tokens as JAX's ``launch/steps.py``."""
    jcfg, cfg, jparams, params = _models("float32", seed=5)
    jt, tt = _tokens(cfg, 2, 28, 6)
    jtok, jpre = jax.jit(J_steps.make_prefill_step(jcfg))(jparams,
                                                          {"tokens": jt})
    tok, pre = steps.make_prefill_step(cfg)(params, {"tokens": tt})
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    jcache = _jax_handoff(jpre, jcfg, 2, 28, 36)
    cache = handoff(pre, api.init_caches(cfg, 2, 36, "cpu"), 28)
    jserve = jax.jit(J_steps.make_serve_step(jcfg))
    got, want = [tok], [jtok]
    for s in range(8):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(28 + s))
        tok, out = steps.make_serve_step(cfg)(params, cache, tok, 28 + s)
        assert out is cache
        got.append(tok)
        want.append(jtok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                  np.concatenate([np.asarray(w)
                                                  for w in want], 1))


def test_serving_runs_the_windowed_flash_and_the_scan(monkeypatch):
    """Prefill calls the flash dispatch once per layer with the layer's
    window (layer 0 global, layer 1 windowed) and the scan once per
    layer; a decode step once each per layer, the scan with T = 1."""
    cfg = ARCHS["hymba-1.5b"].reduced(dtype="float32", chunk_size=8)
    params = api.init_fn(cfg, "cpu")(0)
    flash, scans = [], []
    real_flash, real_scan = attention.flash_attention_gqa, ssm.ssm_chunk_scan

    def counted_flash(q, k, v, scale, causal=True, window=0):
        flash.append((q.shape[1], window))
        return real_flash(q, k, v, scale, causal, window)

    def counted_scan(u, *a):
        scans.append(u.shape[1])
        return real_scan(u, *a)

    monkeypatch.setattr(attention, "flash_attention_gqa", counted_flash)
    monkeypatch.setattr(ssm, "ssm_chunk_scan", counted_scan)
    _, tt = _tokens(cfg, 2, 40, 0)
    tok, pre = steps.make_prefill_step(cfg)(params, {"tokens": tt})
    assert flash == [(40, 0), (40, 32)] and scans == [40, 40]
    cache = handoff(pre, api.init_caches(cfg, 2, 41, "cpu"), 40)
    steps.make_serve_step(cfg)(params, cache, tok, 40)
    assert flash[2:] == [(1, 0), (1, 0)] and scans[2:] == [1, 1]


def test_flash_dispatch_refuses_a_window_without_causal_self_attention():
    q = torch.zeros((1, 8, 2, 16))
    for k, causal in ((torch.zeros((1, 9, 2, 16)), True), (q, False)):
        with pytest.raises(ValueError, match="sliding window"):
            flash_ops.flash_attention_gqa(q, k, k, 0.25, causal, window=4)


def test_params_from_jax_keeps_the_blocks_list_in_jax_order():
    """12 blocks: a list in JAX's order ("blocks/10" after "blocks/9"),
    leaf for leaf equal to ``jax.tree.leaves``; the prefill caches leave
    as the JAX cache tree's leaves, in its order."""
    jcfg, cfg, jparams, params = _models("float32", n_layers=12)
    assert isinstance(params["blocks"], list) and len(params["blocks"]) == 12
    flat = list(T.leaves_with_paths(params))
    jleaves = jax.tree.leaves(jparams)
    assert len(flat) == len(jleaves)
    for (path, got), want in zip(flat, jleaves):
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want),
                                      err_msg=path)
    blocks = [int(p.split("/")[1]) for p, _ in flat if p.startswith("blocks")]
    assert blocks == sorted(blocks) and blocks[-1] == 11
    jt, tt = _tokens(cfg, 1, 8, 0)
    _, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        _, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    got = list(_leaves(pc))
    assert got == [p for p, _ in T.leaves_with_paths(
        jax.tree.map(np.asarray, jc))]
    assert got[:3] == ["blocks/0/attn/k", "blocks/0/attn/v",
                       "blocks/0/ssm/s"] and got[-1] == "blocks/11/ssm/s"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_and_caches_match_jax(dtype):
    """The port's own init and ``init_caches``: the JAX trees' paths,
    shapes and dtypes (windowed k/v min(seq, window) slots)."""
    jcfg = J_ARCHS["hymba-1.5b"].reduced(dtype=dtype, n_layers=3,
                                         global_attn_layers=(0, 2))
    cfg = ARCHS["hymba-1.5b"].reduced(dtype=dtype, n_layers=3,
                                      global_attn_layers=(0, 2))
    pairs = ((api.init_fn(cfg, "cpu")(0), J.init_fn(jcfg)(
        jax.random.PRNGKey(0))), (api.init_caches(cfg, 2, 50, "cpu"),
                                  J.init_caches(jcfg, 2, 50)))
    for got, want in pairs:
        g = dict(T.leaves_with_paths(got))
        w = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
        assert list(g) == list(w)
        for k, v in g.items():
            assert tuple(v.shape) == w[k].shape, k
            assert str(v.dtype)[6:] == str(w[k].dtype), k
    assert transformer._layer_windows(cfg) == [0, 32, 0]
    assert not transformer.uses_scan(cfg)


def test_hybrid_trains_and_serves():
    """Every entry point takes hymba: serving, and since the backward scan
    kernel also ``loss_fn`` and the train shape (the gradients against JAX
    are in ``tests/test_torch_ssm_train.py``)."""
    cfg = ARCHS["hymba-1.5b"].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    api.prefill_fn(cfg), api.decode_fn(cfg)
    api.input_specs(cfg, api.ShapeSpec("d", 8, 1, "decode"), device="cpu")
    batch = api.input_specs(cfg, api.SHAPES["train_4k"], device="meta")
    assert batch["labels"].shape == (256, 4096)
    _, tt = _tokens(cfg, 2, 9, 0)
    loss, _ = api.loss_fn(cfg)(params, {"tokens": tt[:, :-1],
                                        "labels": tt[:, 1:]})
    grads = torch.autograd.grad(loss, T.leaves(params))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
