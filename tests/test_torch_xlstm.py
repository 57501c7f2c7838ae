"""xLSTM (mLSTM and sLSTM blocks) on the CPU: the port against the JAX
package.

The JAX model's parameters cross with ``params_from_jax`` (the ``blocks``
list and each block's ``mix`` tree), its states with ``caches_from_jax``;
the same numpy tokens go through both. Prefill logits, every state leaf
and decode steps are held at ``tests/test_torch_serve.py``'s tolerances
(float32 rtol 1e-5 with an atol of 1e-5 of the largest reference value,
bfloat16 2e-2); gradients as in ``tests/test_torch_ssm_train.py`` (float32
rtol 2e-4 with 2e-4 of the leaf's largest |gradient|; bfloat16 within
2 x JAX's own bfloat16 error of the float32 gradient plus 5e-2 of the
leaf's largest |gradient|, JAX's own bfloat16 errors reaching 4.5% of it
on seeds 0-3). The reduced model has 2 layers (m, s), 4 heads of 16 and a
chunk of 8, so T = 32 walks four chunks.

At a chunk of 256 the mLSTM decay matrix's entries above the diagonal,
exp of a positive sum of -log f over up to 255 steps, overflow to inf:
JAX's ``jnp.where`` then gives a NaN gradient (0 x inf) while the forward
is finite. The port zeroes those entries before the exponential; JAX's
chunk with the same change (patched in the test process only) gives the
port's gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as J_steps
from repro.models import api as J
from repro.models import ssm as J_ssm
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import api, ssm, transformer

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, dtype, err_msg=""):
    want = _np(want)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _models(dtype, seed=0, **kw):
    kw = {"dtype": dtype, "chunk_size": 8, **kw}
    jcfg = J_ARCHS["xlstm-125m"].reduced(**kw)
    cfg = ARCHS["xlstm-125m"].reduced(**kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, api.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def _leaves(tree) -> dict:
    if isinstance(next(iter(T.leaves(tree))), torch.Tensor):
        tree = api.caches_to_numpy(tree)
    return dict(T.leaves_with_paths(jax.tree.map(np.asarray, tree)))


def _close_trees(got, want, dtype, what):
    g, w = _leaves(got), _leaves(want)
    assert list(g) == list(w), (list(g), list(w))
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        _close(torch.from_numpy(np.asarray(g[k], np.float32)), w[k], dtype,
               f"{what} {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_and_states_match_jax(dtype):
    """The port's own init and ``init_caches``: the JAX trees' paths,
    shapes and dtypes (a ``mix`` tree a block, no MLP; states float32)."""
    jcfg = J_ARCHS["xlstm-125m"].reduced(dtype=dtype, n_layers=3)
    cfg = ARCHS["xlstm-125m"].reduced(dtype=dtype, n_layers=3)
    assert transformer._layer_kinds(cfg) == ["m", "s", "m"]
    pairs = ((api.init_fn(cfg, "cpu")(0),
              J.init_fn(jcfg)(jax.random.PRNGKey(0))),
             (api.init_caches(cfg, 2, 50, "cpu"), J.init_caches(jcfg, 2, 50)))
    for got, want in pairs:
        g = dict(T.leaves_with_paths(got))
        w = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
        assert list(g) == list(w)
        for k, v in g.items():
            assert tuple(v.shape) == w[k].shape, k
            assert str(v.dtype)[6:] == str(w[k].dtype), k
    p = pairs[0][0]
    assert sorted(p["blocks"][1]["mix"]) == ["r", "w_in", "w_o"]
    # the same seed, the same values
    again = api.init_fn(cfg, "cpu")(0)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(p),
                                                 T.leaves(again)))


@pytest.mark.parametrize("t", [32, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(t, dtype):
    """Last logits and every state leaf (C, n of the mLSTM; c, n, h of the
    sLSTM); T = 32 walks four chunks of 8, T = 6 one chunk of 6."""
    jcfg, cfg, jparams, params = _models(dtype)
    jt, tt = _tokens(cfg, 2, t, t)
    jl, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    assert pl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, dtype, "prefill logits")
    _close_trees(pc, jc, dtype, "prefill")
    caches = api.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    _close_trees(caches, jc, dtype, "caches_from_jax")


def test_mlstm_forward_asserts_a_chunk_multiple():
    _, cfg, _, params = _models("float32")
    x = torch.zeros((1, 12, cfg.d_model))
    with pytest.raises(AssertionError, match="chunk multiple"):
        ssm.mlstm_forward(params["blocks"][0]["mix"], x, cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """Prefill of 16 tokens, its states handed to ``init_caches`` states,
    then 8 teacher-forced decode steps: logits at every step and every
    state at the end against JAX; the states are written in place."""
    jcfg, cfg, jparams, params = _models(dtype, seed=1)
    jt, tt = _tokens(cfg, 2, 24, 2)
    _, jpre = J.prefill_fn(jcfg)(jparams, {"tokens": jt[:, :16]})
    with torch.no_grad():
        _, pre = api.prefill_fn(cfg)(params, {"tokens": tt[:, :16]})
    cache = api.init_caches(cfg, 2, 24, "cpu")
    with torch.no_grad():
        for dst, src in zip(T.leaves(cache), T.leaves(pre)):
            dst.copy_(src)
    jcache = jpre
    ptrs = [leaf.data_ptr() for leaf in T.leaves(cache)]
    jstep = jax.jit(J.decode_fn(jcfg))
    for pos in range(16, 24):
        jlog, jcache = jstep(jparams, jcache, jt[:, pos:pos + 1],
                             jnp.int32(pos))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache, tt[:, pos:pos + 1],
                                          pos)
        assert out is cache
        _close(log, jlog, dtype, f"decode logits, position {pos}")
    assert [leaf.data_ptr() for leaf in T.leaves(cache)] == ptrs
    _close_trees(cache, jcache, dtype, "decode")


def test_decode_continues_a_prefill():
    """Float32: decode after a prefill of 24 gives the logits of a fresh
    prefill of the 32 tokens (the recurrent and chunkwise forms agree)."""
    _, cfg, _, params = _models("float32", seed=3)
    _, tt = _tokens(cfg, 2, 32, 4)
    with torch.no_grad():
        _, pre = api.prefill_fn(cfg)(params, {"tokens": tt[:, :24]})
        for pos in range(24, 32):
            log, pre = api.decode_fn(cfg)(params, pre, tt[:, pos:pos + 1],
                                          pos)
        fresh, _ = api.prefill_fn(cfg)(params, {"tokens": tt})
    _close(log, fresh, "float32", "decode vs fresh prefill")


def test_greedy_steps_match_jax_launch_steps():
    jcfg, cfg, jparams, params = _models("float32", seed=5)
    jt, tt = _tokens(cfg, 2, 16, 6)
    jtok, jcache = jax.jit(J_steps.make_prefill_step(jcfg))(
        jparams, {"tokens": jt})
    tok, cache = steps.make_prefill_step(cfg)(params, {"tokens": tt})
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    jserve = jax.jit(J_steps.make_serve_step(jcfg))
    got, want = [tok], [jtok]
    for s in range(8):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(16 + s))
        tok, out = steps.make_serve_step(cfg)(params, cache, tok, 16 + s)
        assert out is cache
        got.append(tok)
        want.append(jtok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                  np.concatenate([np.asarray(w)
                                                  for w in want], 1))


def test_slstm_scan_passes_gradcheck():
    """``SLSTMScan`` in float64: every input (the projection, r and the
    three initial states) against every output (the hidden states and the
    three final states), with random initial states."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s)).requires_grad_()
    args = (f(2, 5, 2, 12), f(2, 3, 12) * 0.5, f(2, 2, 3), f(2, 2, 3).abs(),
            f(2, 2, 3))
    args = tuple(a.detach().requires_grad_() for a in args)
    assert torch.autograd.gradcheck(ssm.SLSTMScan.apply, args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_training_forward_equals_the_serving_loop(dtype):
    """``slstm_forward`` under grad (``SLSTMScan`` keeping every step's
    states for its backward) and without (keeping none): the same output
    and final state, bit for bit."""
    _, cfg, _, params = _models(dtype, seed=4)
    p = params["blocks"][1]["mix"]
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)).to(getattr(torch,
                                                                  dtype))
    out, st = ssm.slstm_forward(p, x, cfg)
    assert out.grad_fn is not None
    with torch.no_grad():
        out2, st2 = ssm.slstm_forward(p, x, cfg)
    assert torch.equal(out.detach(), out2)
    assert all(torch.equal(st[k].detach(), st2[k]) for k in st)


def _batches(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, t + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


def _port_grads(cfg, params, batch):
    loss, _ = api.loss_fn(cfg)(params, batch)
    return loss.detach(), torch.autograd.grad(loss, T.leaves(params))


def test_loss_and_every_gradient_match_jax_float32():
    jcfg, cfg, jparams, params = _models("float32", seed=7, n_layers=3)
    jb, b = _batches(cfg, 2, 32, 8)
    (jl, _), jg = jax.value_and_grad(J.loss_fn(jcfg), has_aux=True)(jparams,
                                                                   jb)
    loss, grads = _port_grads(cfg, params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    assert len(paths) == len(jax.tree.leaves(jg))
    for path, g, w in zip(paths, grads, jax.tree.leaves(jg)):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=path)
    l2, g2 = _port_grads(dataclasses.replace(cfg, remat=False), params, b)
    assert torch.equal(loss, l2)
    assert all(torch.equal(x, y) for x, y in zip(grads, g2))


def test_loss_and_every_gradient_match_jax_bfloat16():
    jcfg, cfg, jparams, params = _models("bfloat16", seed=9)
    jb, b = _batches(cfg, 2, 32, 10)
    (jl, _), jg = jax.value_and_grad(J.loss_fn(jcfg), has_aux=True)(jparams,
                                                                   jb)
    j32 = dataclasses.replace(jcfg, dtype="float32")
    truth = jax.grad(lambda p: J.loss_fn(j32)(p, jb)[0])(
        jax.tree.map(lambda a: a.astype(jnp.float32), jparams))
    loss, grads = _port_grads(cfg, params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=2e-2)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    for path, g, w, tr in zip(paths, grads, jax.tree.leaves(jg),
                              jax.tree.leaves(truth)):
        tr = _np(tr)
        ours, theirs = np.abs(_np(g) - tr).max(), np.abs(_np(w) - tr).max()
        assert ours <= 2 * theirs + 5e-2 * np.abs(tr).max(), (path, ours,
                                                              theirs)


def _safe_chunk(carry, inp, hd):
    """JAX's ``_mlstm_chunk`` with the decay matrix zeroed above the
    diagonal before its exponential, as the port computes it."""
    C, n = carry
    q, k, v, ig, fg = inp
    c = q.shape[1]
    logf = jnp.log(fg + 1e-8)
    cumf = jnp.cumsum(logf, axis=1)
    decay_to_t = jnp.exp(cumf)
    h_inter = jnp.einsum("bhde,bche->bchd", C, q) * decay_to_t[..., None]
    n_inter = jnp.einsum("bhd,bchd->bch", n, q) * decay_to_t
    dmat = cumf[:, :, None, :] - cumf[:, None, :, :]
    tri = jnp.tril(jnp.ones((c, c), bool))[None, :, :, None]
    dmat = jnp.where(tri, jnp.exp(jnp.where(tri, dmat, 0.0)), 0.0)
    dmat = dmat * ig[:, None, :, :]
    scores = jnp.einsum("bthd,bshd->btsh", q, k).astype(jnp.float32)
    w = scores * dmat
    h_intra = jnp.einsum("btsh,bshd->bthd", w.astype(v.dtype), v)
    n_intra = jnp.einsum("btsh,bshd->bth", w, k.astype(jnp.float32))
    h = (h_inter + h_intra) / jnp.maximum(jnp.abs(n_inter + n_intra),
                                          1.0)[..., None]
    decay_all = jnp.exp(cumf[:, -1])
    w_end = jnp.exp(cumf[:, -1:, :] - cumf) * ig
    C_new = C * decay_all[..., None, None] + jnp.einsum(
        "bch,bchd,bche->bhde", w_end, v.astype(jnp.float32),
        k.astype(jnp.float32))
    n_new = n * decay_all[..., None] + jnp.einsum(
        "bch,bchd->bhd", w_end, k.astype(jnp.float32))
    return (C_new, n_new), h


def test_long_chunk_gradient_is_finite_where_jax_gives_nan(monkeypatch):
    """Chunk 256 at T = 256: JAX's loss is finite and its gradient NaN;
    the port's loss equals it and its gradient is finite and equals that
    of JAX's chunk with the port's change."""
    jcfg, cfg, jparams, params = _models("float32", seed=11, chunk_size=256,
                                         n_layers=1)
    jb, b = _batches(cfg, 1, 256, 12)
    lfn = J.loss_fn(jcfg)
    (jl, _), jg = jax.value_and_grad(lfn, has_aux=True)(jparams, jb)
    assert np.isfinite(float(jl))
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jg))
    loss, grads = _port_grads(cfg, params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    monkeypatch.setattr(J_ssm, "_mlstm_chunk", _safe_chunk)
    jax.clear_caches()              # scan's traced body would be reused
    jg = jax.grad(lambda p: J.loss_fn(jcfg)(p, jb)[0])(jparams)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    for path, g, w in zip(paths, grads, jax.tree.leaves(jg)):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=2e-4,
                                   atol=2e-4 * float(np.abs(w).max()),
                                   err_msg=path)


def test_main_trains_xlstm_and_resumes_bitwise(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
            "--n-dev", "2", "--global-batch", "4", "--seq", "32", "--steps",
            "4", "--compress", "topk:0.05", "--ckpt-every", "2",
            "--log-every", "1"]
    full = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(full) == 4 and np.isfinite(full).all()
    import shutil
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == full[2:]
    a = np.load(tmp_path / "a" / "step_00000004" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_00000004" / "arrays.npz")
    assert sorted(a) == sorted(b) and "params/blocks/1/mix/r::bf16" in a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
