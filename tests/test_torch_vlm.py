"""The port's VLM prefix (llava-next-34b) on the CPU vs the JAX package's.

A VLM is the dense stack with its image embeddings, ``prefix_embeds`` (B,
P, d), ahead of the token embeddings; the vision frontend is a stub, as in
JAX. The JAX model's parameters cross to the port with
``params_from_jax``; the same numpy prefix embeddings and tokens go
through both. The prefix's positions count: prefill's rope runs over P +
T positions, and a decode step's ``pos`` is P + T + step. Tolerances:
float32 rtol 1e-5, bfloat16 rtol 2e-2, each with an atol of the same
factor times the largest reference value (``tests/test_torch_serve.py``'s),
gradient leaves each against its own largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as J_steps
from repro.models import api as J
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import api

NAME = "llava-next-34b"
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


def _models(dtype, seed=0):
    jcfg = J_ARCHS[NAME].reduced(dtype=dtype)
    cfg = ARCHS[NAME].reduced(dtype=dtype)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, b, p, t, seed, labels=False):
    """p prefix embeddings (float32, at the token embeddings' scale; the
    model casts them) and t tokens, as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    pre = (0.02 * rng.normal(size=(b, p, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=(b, t + 1)).astype(np.int32)
    jb = {"prefix_embeds": jnp.asarray(pre),
          "tokens": jnp.asarray(toks[:, :-1])}
    tb = {"prefix_embeds": torch.as_tensor(pre),
          "tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int64)}
    if labels:
        jb["labels"] = jnp.asarray(toks[:, 1:])
        tb["labels"] = torch.as_tensor(toks[:, 1:], dtype=torch.int64)
    return jb, tb


def _leaves(tree) -> dict:
    if isinstance(next(iter(T.leaves(tree))), torch.Tensor):
        tree = api.caches_to_numpy(tree)
    return dict(T.leaves_with_paths(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_with_prefix_embeds_matches_jax(dtype):
    """The last logits and the caches, P + T positions long."""
    jcfg, cfg, jparams, params = _models(dtype)
    jb, tb = _batch(cfg, 2, cfg.n_prefix_embeds, 12, 1)
    jl, jc = J.prefill_fn(jcfg)(jparams, jb)
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, tb)
    _close(pl, jl, dtype, "prefill logits")
    got, want = _leaves(pc), _leaves(jc)
    assert sorted(got) == sorted(want) == ["layers/k", "layers/v"]
    for k in want:
        assert got[k].shape == want[k].shape == (
            cfg.n_layers, 2, 8 + 12, cfg.n_kv_heads, cfg.hd), k
        _close(torch.from_numpy(np.asarray(got[k], np.float32)), want[k],
               dtype, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_with_the_prefix_sliced_off(dtype):
    """The loss over the text positions only (the prefix has no labels)
    and every gradient leaf against JAX's."""
    jcfg, cfg, jparams, params = _models(dtype)
    jb, tb = _batch(cfg, 2, cfg.n_prefix_embeds, 10, 2, labels=True)
    (jloss, _), jgrads = jax.value_and_grad(J.loss_fn(jcfg),
                                            has_aux=True)(jparams, jb)
    loss, _ = api.loss_fn(cfg)(params, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=TOL[dtype])
    named = list(T.leaves_with_paths(params))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(k for k, _ in named)
    for (k, _), g in zip(named, grads):
        assert tuple(g.shape) == jflat[k].shape, k
        _close(g, jflat[k], dtype, k)


def _decode_both(dtype, offset=0):
    """Prefill with the prefix, the caches handed into P + T + 8 slots on
    both sides, then 8 greedy steps at positions P + T + step (less
    ``offset`` on the port's side). Returns (port, JAX) tokens and last
    logits per step."""
    jcfg, cfg, jparams, params = _models(dtype)
    b, p, t = 2, cfg.n_prefix_embeds, 12
    jb, tb = _batch(cfg, b, p, t, 3)
    jtok, jc = J_steps.make_prefill_step(jcfg)(jparams, jb)
    tok, pc = steps.make_prefill_step(cfg)(params, tb)
    n = p + t
    jcache = J.init_caches(jcfg, b, n + 8)
    jcache = {"prefix": [], "layers": {
        k: jcache["layers"][k].at[:, :, :n].set(jc["layers"][k])
        for k in ("k", "v")}}
    cache = api.decode_caches(cfg, pc, tb, 8)
    jstep = jax.jit(J.decode_fn(jcfg))
    out = {"port": ([tok.numpy()], []), "jax": ([np.asarray(jtok)], [])}
    for i in range(8):
        jlog, jcache = jstep(jparams, jcache, jtok, jnp.int32(n + i))
        with torch.no_grad():
            log, _ = api.decode_fn(cfg)(params, cache, tok, n + i - offset)
        jtok = jnp.argmax(jlog[:, -1], -1).astype(jnp.int32)[:, None]
        tok = torch.argmax(log[:, -1], -1).to(torch.int32)[:, None]
        for key, (tk, lg) in (("port", (tok, log)), ("jax", (jtok, jlog))):
            out[key][0].append(np.asarray(tk))
            out[key][1].append(_f32(lg))
    return ({k: (np.concatenate(a, 1), b) for k, (a, b) in out.items()})


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_at_prefix_plus_text_positions_matches_jax(dtype):
    """8 greedy steps at P + T + step: every step's logits against JAX's,
    equal tokens."""
    out = _decode_both(dtype)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    for i, (got, want) in enumerate(zip(out["port"][1], out["jax"][1])):
        _close(got, want, dtype, f"decode logits, step {i}")


def test_decode_positions_without_the_prefix_are_seen():
    """A planted fault: decode positions counted from the text alone (T +
    step, the prefix left out) put the k/v into the prefix's slots and
    rope the query at the wrong position; the logits part from JAX's
    beyond the float32 tolerance."""
    out = _decode_both("float32", offset=8)
    with pytest.raises(AssertionError):
        _close(out["port"][1][0], out["jax"][1][0], "float32")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_prefix_count(shape, mode):
    """P = min(n_prefix_embeds, S // 2) prefix embeddings in the model
    dtype and S - P tokens to train and prefill (decode: S tokens), at the
    published config (2,880 embeddings) and at the reduced one (8), equal
    to JAX's shapes."""
    for jcfg, cfg in ((J_ARCHS[NAME], ARCHS[NAME]),
                      (J_ARCHS[NAME].reduced(), ARCHS[NAME].reduced())):
        spec = api.SHAPES[shape]
        want = jax.eval_shape(lambda: J.input_specs(jcfg, J.SHAPES[shape],
                                                    mode))
        got = api.input_specs(cfg, spec, mode, device="meta")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
        if mode == "decode":
            continue
        p = min(cfg.n_prefix_embeds, spec.seq_len // 2)
        assert got["prefix_embeds"].shape == (spec.global_batch, p,
                                              cfg.d_model)
        assert got["prefix_embeds"].dtype == torch.bfloat16
        assert got["tokens"].shape[1] == spec.seq_len - p


def test_prefix_is_cast_to_the_embedding_dtype():
    """float32 prefix embeddings into a bfloat16 model give what the same
    embeddings rounded to bfloat16 give, bit for bit."""
    _, cfg, _, params = _models("bfloat16")
    _, tb = _batch(cfg, 2, cfg.n_prefix_embeds, 6, 4)
    rounded = dict(tb, prefix_embeds=tb["prefix_embeds"].to(torch.bfloat16))
    with torch.no_grad():
        a, ca = api.prefill_fn(cfg)(params, tb)
        b, cb = api.prefill_fn(cfg)(params, rounded)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert torch.equal(ca["layers"]["k"], cb["layers"]["k"])
