"""The port's MoE (dense dispatch) on the CPU vs the JAX package's.

JAX weights cross with ``params_from_jax`` (an MoE layer's ``moe/router``,
``moe/experts`` and ``moe/shared`` leaves, and the dense ``prefix`` blocks
as a list) and the same numpy inputs, made from a seed, go through both.
The dispatch's integer parts (routing, order, destinations, keep mask,
drops) are held equal. The layer's output and aux loss in float32 are held
to rtol 1e-5 with an atol of 1e-5 times the largest value (summation
order; entries near zero have no relative precision), in bfloat16 to 2e-2
of the largest value. kimi-k2 and deepseek-v2 ``reduced()`` (2 layers: a
dense prefix block and one MoE layer of 4 experts, top-2, a shared
expert) are held as ``tests/test_torch_serve.py`` holds serving (logits
and caches at those tolerances, greedy tokens equal) and as
``tests/test_torch_model.py`` holds training (float32 loss rtol 1e-5,
gradients rtol 1e-4 atol 1e-6; bfloat16 loss rtol 2e-2, gradients 0.1 of
each leaf's largest).
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
from repro.models import moe as J_moe
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import api, moe, transformer

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
KIMI, DEEPSEEK = "kimi-k2-1t-a32b", "deepseek-v2-236b"


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


def _cfgs(name=KIMI, dtype="float32", **kw):
    return (J_ARCHS[name].reduced(dtype=dtype, **kw),
            ARCHS[name].reduced(dtype=dtype, **kw))


def _models(name=KIMI, dtype="float32", seed=0, **kw):
    jcfg, cfg = _cfgs(name, dtype, **kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# _sort_into_bins and the top-k
# ---------------------------------------------------------------------------

SORT_CASES = [
    ([1, 0, 1, 1, 2, 0], 3, 2),      # tests/test_moe_ep.py: bin 1 overflows
    ([3, 3, 1], 3, 4),               # tests/test_moe_ep.py: 3 == n_bins
]


def _sort_both(ids, n_bins, cap):
    jo, jd, jk = J_moe._sort_into_bins(jnp.asarray(ids, jnp.int32), n_bins,
                                       cap)
    o, d, k = moe._sort_into_bins(torch.as_tensor(ids, dtype=torch.int64),
                                  n_bins, cap)
    for what, got, want in (("order", o, jo), ("dest", d, jd),
                            ("keep", k, jk)):
        np.testing.assert_array_equal(_np(got), np.asarray(want),
                                      err_msg=what)
    return _np(d), _np(k)


@pytest.mark.parametrize("ids,n_bins,cap", SORT_CASES)
def test_sort_into_bins_local_cases_match_jax(ids, n_bins, cap):
    """The two local cases of ``tests/test_moe_ep.py``, with their own
    assertions, and every output equal to JAX's."""
    dest, keep = _sort_both(ids, n_bins, cap)
    if n_bins == 3 and cap == 2:
        assert int(keep.sum()) == 5
        kept = dest[keep]
        assert len(set(kept.tolist())) == 5 and (kept < 6).all()
    else:
        assert int(keep.sum()) == 1


@pytest.mark.parametrize("r,n_bins,cap", [(1, 1, 1), (37, 5, 3),
                                          (200, 16, 9), (200, 16, 40),
                                          (513, 64, 1)])
def test_sort_into_bins_random_match_jax(r, n_bins, cap):
    """Random bins with invalid ids (== n_bins and beyond) among them:
    order, destinations and keep mask equal to JAX's; kept slots
    distinct, in range, and within their bin's rows."""
    ids = np.random.default_rng(r + cap).integers(0, n_bins + 2, size=r)
    dest, keep = _sort_both(ids, n_bins, cap)
    kept = dest[keep]
    assert len(set(kept.tolist())) == len(kept) and (kept < n_bins * cap).all()
    assert (dest[~keep] == n_bins * cap).all()
    want = sum(min(cap, int((ids == b).sum())) for b in range(n_bins))
    assert int(keep.sum()) == want


def test_top_k_puts_the_lower_index_first_on_ties():
    """``lax.top_k``'s order on rows of ties, which ``torch.topk`` does not
    promise."""
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(g), 5)
    v, i = moe.top_k(torch.from_numpy(g), 5)
    np.testing.assert_array_equal(_np(i), np.asarray(ji))
    np.testing.assert_array_equal(_np(v), np.asarray(jv))


# ---------------------------------------------------------------------------
# the dense dispatch
# ---------------------------------------------------------------------------

def _layer(dtype, seed=0, tie=False, **kw):
    """One MoE layer of the reduced kimi-k2 (8 experts, top-3), its JAX
    and port weights, and an input (2, 16, d) from a seed. With ``tie``
    expert 2's router column is expert 5's, so the two gates are equal
    for every token."""
    base = dict(n_experts=8, top_k=3)
    jcfg, cfg = _cfgs(KIMI, dtype, **{**base, **kw})
    jp = J_moe.init_moe(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    if tie:
        jp["router"]["w"] = jp["router"]["w"].copy()
        jp["router"]["w"][:, 2] = jp["router"]["w"][:, 5]
    p = api.params_from_jax(jp, "cpu")
    x = np.random.default_rng(seed + 1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), p, jx, tx


def _jax_dispatch(jp, jx, jcfg):
    """The JAX dense path's routing (its lines on ``gates`` and
    ``top_k``) and its dispatch, by its ``_sort_into_bins`` (the same
    arithmetic for ids below E)."""
    E, k = jcfg.n_experts, jcfg.top_k
    xt = jx.reshape(-1, jx.shape[-1])
    gates = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"]["w"],
                           axis=-1)
    _, eidx = jax.lax.top_k(gates, k)
    C = max(1, int(np.ceil(xt.shape[0] * k / E * jcfg.capacity_factor)))
    return (np.asarray(gates), np.asarray(eidx),
            J_moe._sort_into_bins(eidx.reshape(-1), E, C), C)


MOE_CASES = [
    pytest.param("swiglu", 1, False, 1.25, id="swiglu-shared"),
    pytest.param("swiglu", 0, False, 1.25, id="swiglu-no-shared"),
    pytest.param("gelu", 1, False, 1.25, id="gelu-shared"),
    pytest.param("relu2", 0, False, 1.25, id="relu2-no-shared"),
    pytest.param("swiglu", 1, True, 1.25, id="swiglu-tie"),
    pytest.param("swiglu", 1, False, 0.5, id="swiglu-drops"),
    pytest.param("gelu", 0, True, 0.5, id="gelu-tie-drops"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type,shared,tie,cf", MOE_CASES)
def test_moe_forward_dense_matches_jax(mlp_type, shared, tie, cf, dtype):
    """``_moe_forward_dense`` against JAX's: the routing (expert ids, ties
    to the lower id), the drop count and the kept pairs' destinations
    equal, the output and the aux loss within the dtype's tolerance."""
    jcfg, cfg, jp, p, jx, tx = _layer(dtype, tie=tie, mlp_type=mlp_type,
                                      n_shared_experts=shared,
                                      capacity_factor=cf)
    assert ("shared" in p) == bool(shared)
    assert ("w_gate" in p["experts"]) == (mlp_type == "swiglu")
    jgates, jeidx, (jo, jd, jk), C = _jax_dispatch(jp, jx, jcfg)
    xt = tx.reshape(-1, cfg.d_model)
    gates, _, eidx = moe.route(p, xt, cfg)
    np.testing.assert_array_equal(_np(eidx), jeidx)
    if tie:      # the planted tie is there, bitwise, in both
        assert (_np(gates)[:, 2] == _np(gates)[:, 5]).all()
        assert (jgates[:, 2] == jgates[:, 5]).all()
        assert ((jeidx == 2).any(1) != (jeidx == 5).any(1)).any()
    assert moe.expert_capacity(xt.shape[0], cfg) == C
    o, d, k = moe._sort_into_bins(eidx.reshape(-1), cfg.n_experts, C)
    np.testing.assert_array_equal(_np(o), np.asarray(jo))
    np.testing.assert_array_equal(_np(k), np.asarray(jk))
    np.testing.assert_array_equal(_np(d)[_np(k)], np.asarray(jd)[_np(k)])
    drops = int((~k).sum())
    assert drops == int((~np.asarray(jk)).sum())
    assert drops > 0 or cf > 1
    jy, jaux = J_moe._moe_forward_dense(jp, jx, jcfg)
    with torch.no_grad():
        y, aux = moe.moe_forward(p, tx, cfg)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert aux.dtype == torch.float32
    _close(y, jy, dtype, "output")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL["float32"])


def test_dropped_pairs_reach_neither_output_nor_gradient():
    """With capacity 1 most pairs drop into the sink row: the output is
    the kept pairs' alone (each token's rows recomputed by hand), and the
    gradient of a token whose pairs all dropped is the shared expert's
    alone."""
    _, cfg, _, p, _, tx = _layer("float32", capacity_factor=0.01)
    E, k = cfg.n_experts, cfg.top_k
    assert moe.expert_capacity(32, cfg) == 1
    x = tx.clone().requires_grad_()
    y, _ = moe.moe_forward(p, x, cfg)
    xt = x.detach().reshape(-1, cfg.d_model)
    _, gate_w, eidx = moe.route(p, xt, cfg)
    order, dest, keep = moe._sort_into_bins(eidx.reshape(-1), E, 1)
    kept = torch.zeros(eidx.numel(), dtype=torch.bool)
    kept[order[keep]] = True
    kept = kept.view(-1, k)
    assert int(kept.sum()) == len(set(eidx.reshape(-1).tolist())) <= E
    want = moe.apply_mlp(p["shared"], xt, cfg)
    ws = p["experts"]
    for n in range(xt.shape[0]):
        for j in range(k):
            if kept[n, j]:
                e = int(eidx[n, j])
                h = torch.nn.functional.silu(xt[n] @ ws["w_gate"][e]) * (
                    xt[n] @ ws["w_up"][e])
                want[n] += gate_w[n, j] * (h @ ws["w_down"][e])
    _close(y.reshape(-1, cfg.d_model), _np(want), "float32")
    y.sum().backward()
    lone = [n for n in range(xt.shape[0]) if not kept[n].any()]
    assert lone
    xs = xt[lone].clone().requires_grad_()
    moe.apply_mlp(p["shared"], xs, cfg).sum().backward()
    np.testing.assert_allclose(_np(x.grad.reshape(-1, cfg.d_model)[lone]),
                               _np(xs.grad), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# kimi-k2 and deepseek-v2, reduced: serving
# ---------------------------------------------------------------------------

def _cache_leaves(caches) -> dict:
    if isinstance(next(iter(T.leaves(caches))), torch.Tensor):
        caches = api.caches_to_numpy(caches)
    return dict(T.leaves_with_paths(jax.tree.map(np.asarray, caches)))


def _close_caches(got, want, dtype, what, attn):
    g, w = _cache_leaves(got), _cache_leaves(want)
    names = ["ckv", "kr"] if attn == "mla" else ["k", "v"]
    assert sorted(g) == sorted(w) == sorted(
        [f"layers/{n}" for n in names] + [f"prefix/0/{n}" for n in names])
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        _close(torch.from_numpy(np.asarray(g[k], np.float32)), w[k], dtype,
               f"{what} {k}")


SERVE_CASES = [(KIMI, "float32"), (DEEPSEEK, "float32"),
               (KIMI, "bfloat16"), (DEEPSEEK, "bfloat16")]


@pytest.mark.parametrize("name,dtype", SERVE_CASES)
def test_prefill_then_decode_match_jax(name, dtype):
    """Prefill of a (2, 12) prompt, then 4 decode steps from zero caches
    fed the prompt's tokens: logits at each step and the prefix and
    stacked caches against JAX."""
    jcfg, cfg, jparams, params = _models(name, dtype)
    assert len(params["prefix"]) == 1 and "moe" in params["layers"]
    jt, tt = _tokens(cfg, 2, 12, 1)
    jl, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    assert pl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, dtype, "prefill logits")
    _close_caches(pc, jc, dtype, "prefill", cfg.attn_type)
    jstep = jax.jit(J.decode_fn(jcfg))
    jcache = J.init_caches(jcfg, 2, 16)
    cache = api.init_caches(cfg, 2, 16, "cpu")
    assert len(cache["prefix"]) == 1
    assert next(iter(cache["layers"].values())).shape[0] == 1
    ptrs = [x.data_ptr() for x in T.leaves(cache)]
    for t in range(4):
        jlog, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.int32(t))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
        assert out is cache
        _close(log, jlog, dtype, f"decode logits, step {t}")
    assert [x.data_ptr() for x in T.leaves(cache)] == ptrs
    _close_caches(cache, jcache, dtype, "decode", cfg.attn_type)


@pytest.mark.parametrize("name", [KIMI, DEEPSEEK])
def test_greedy_steps_match_jax_launch_steps(name):
    """``make_prefill_step`` then 4 ``make_serve_step``s, float32, batch
    3 (decode capacity max(1, ceil(3 x 2 / 4 x 1.25)) = 2, so pairs can
    drop): the same greedy tokens as JAX's ``launch/steps.py``."""
    jcfg, cfg, jparams, params = _models(name, "float32", seed=5)
    jt, tt = _tokens(cfg, 3, 10, 6)
    jtok, jc = jax.jit(J_steps.make_prefill_step(jcfg))(jparams,
                                                        {"tokens": jt})
    tok, pc = steps.make_prefill_step(cfg)(params, {"tokens": tt})
    jcache = jax.tree.map(
        lambda z, c: jax.lax.dynamic_update_slice(z, c, (0,) * z.ndim),
        J.init_caches(jcfg, 3, 14), jc)
    cache = api.init_caches(cfg, 3, 14, "cpu")
    with torch.no_grad():
        for got, pre in zip(T.leaves(cache["prefix"]),
                            T.leaves(pc["prefix"])):
            got[:, :10] = pre               # a prefix block's (B, S, ...)
        for n, got in cache["layers"].items():
            got[:, :, :10] = pc["layers"][n]    # the stack's (L, B, S, ...)
    jserve = jax.jit(J_steps.make_serve_step(jcfg))
    got, want = [tok], [jtok]
    for s in range(4):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(10 + s))
        tok, out = steps.make_serve_step(cfg)(params, cache, tok, 10 + s)
        assert out is cache
        got.append(tok)
        want.append(jtok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                  np.concatenate([np.asarray(w)
                                                  for w in want], 1))


def test_decode_capacity_drops_as_jax_decides():
    """A decode step of batch 4 on 4 experts, top-2 at capacity factor
    0.5 (capacity 1): pairs drop at decode, and the logits still equal
    JAX's."""
    jcfg, cfg, jparams, params = _models(KIMI, "float32", seed=3,
                                         capacity_factor=0.5)
    assert moe.expert_capacity(4, cfg) == 1
    jt, tt = _tokens(cfg, 4, 3, 3)
    jstep = jax.jit(J.decode_fn(jcfg))
    jcache = J.init_caches(jcfg, 4, 4)
    cache = api.init_caches(cfg, 4, 4, "cpu")
    drops = []
    real = moe._sort_into_bins

    def counted(*a):
        out = real(*a)
        drops.append(int((~out[2]).sum()))
        return out

    moe._sort_into_bins = counted
    try:
        for t in range(3):
            jlog, jcache = jstep(jparams, jcache, jt[:, t:t + 1],
                                 jnp.int32(t))
            with torch.no_grad():
                log, _ = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
            _close(log, jlog, "float32", f"step {t}")
    finally:
        moe._sort_into_bins = real
    assert len(drops) == 3 and all(d >= 4 for d in drops)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_caches_from_jax_round_trip_with_a_prefix(dtype):
    jcfg = J_ARCHS[KIMI].reduced(dtype=dtype)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(0))
    _, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jnp.ones((2, 6),
                                                            jnp.int32)})
    caches = api.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(caches["prefix"], list) and len(caches["prefix"]) == 1
    back = _cache_leaves(caches)
    for k, a in _cache_leaves(jc).items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(back[k].view(np.uint8),
                                      a.view(np.uint8), err_msg=k)


def test_serving_takes_flash_and_never_sdpa(monkeypatch):
    """kimi-k2's prefill and decode attention, prefix block and MoE layer,
    go through the flash kernel's dispatch only."""
    from repro_torch.models import attention
    cfg = ARCHS[KIMI].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    calls = []
    real = attention.flash_attention_gqa

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("sdpa on the serving path")

    monkeypatch.setattr(attention, "flash_attention_gqa", counted)
    monkeypatch.setattr(attention, "sdpa", refuse)
    monkeypatch.setattr(attention, "sdpa_blocked", refuse)
    _, tt = _tokens(cfg, 2, 8, 0)
    tok, _ = steps.make_prefill_step(cfg)(params, {"tokens": tt})
    steps.make_serve_step(cfg)(params, api.init_caches(cfg, 2, 9, "cpu"),
                               tok, 8)
    assert calls == [8, 8, 1, 1]


# ---------------------------------------------------------------------------
# training: loss and gradients
# ---------------------------------------------------------------------------

def _run_both(name, b, t, seed=0, **kw):
    jcfg, cfg, jparams, params = _models(name, seed=seed, **kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, t + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int64),
          "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64)}
    (jloss, jmet), jgrads = jax.value_and_grad(J.loss_fn(jcfg), has_aux=True)(
        jparams, jb)
    loss, met = api.loss_fn(cfg)(params, tb)
    named = list(T.leaves_with_paths(params))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(k for k, _ in named)
    return (loss, met, jloss, jmet,
            [(k, g, jflat[k]) for (k, _), g in zip(named, grads)])


@pytest.mark.parametrize("name,cf", [(KIMI, 1.25), (DEEPSEEK, 1.25),
                                     (KIMI, 0.5)])
def test_loss_and_grads_match_f32(name, cf):
    """Loss, nll, the aux loss (nonzero: 0.01 x aux is in the loss) and
    every gradient, router and experts included; at capacity factor 0.5
    pairs drop in training."""
    loss, met, jloss, jmet, grads = _run_both(name, 2, 16, dtype="float32",
                                              capacity_factor=cf)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["nll"].detach()),
                               float(jmet["nll"]), rtol=1e-5)
    assert float(jmet["aux"]) > 0.5
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(jmet["aux"]), rtol=1e-5)
    for k, g, jg in grads:
        assert g.dtype == torch.float32 and tuple(g.shape) == jg.shape, k
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    routed = [k for k, g, _ in grads if k.startswith("layers/moe/")]
    assert len(routed) == 7 and all(
        float(g.abs().max()) > 0 for k, g, _ in grads if k in routed)


def test_loss_and_grads_match_bf16():
    loss, _, jloss, _, grads = _run_both(KIMI, 2, 16, dtype="bfloat16")
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-2)
    for k, g, jg in grads:
        want = torch.float32 if k.endswith("router/w") else torch.bfloat16
        assert g.dtype == want, k
        scale = float(np.abs(_f32(jg)).max())
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=0,
                                   atol=0.1 * scale + 1e-30, err_msg=k)


@pytest.mark.parametrize("name", [KIMI, DEEPSEEK])
def test_stacked_remat_is_bitwise_no_remat(name):
    """Remat checkpoints each stacked MoE layer, its aux returned beside
    its output: loss, aux and every gradient equal bit for bit to no
    remat."""
    cfg = ARCHS[name].reduced(dtype="float32")
    assert cfg.remat and transformer.uses_scan(cfg)
    params = api.init_fn(cfg, "cpu")(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for remat in (True, False):
        loss, met = api.loss_fn(dataclasses.replace(cfg, remat=remat))(
            params, batch)
        out.append((loss.detach(), met["aux"].detach(),
                    torch.autograd.grad(loss, T.leaves(params))))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1]) and float(out[0][1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(out[0][2], out[1][2]))


@pytest.mark.parametrize("name", [KIMI, DEEPSEEK])
def test_blocks_path_matches_jax(name):
    """Without a stack (``scan_layers=False``) every layer is a block of
    the ``blocks`` list, the first dense and the rest MoE, as JAX builds
    it; loss and gradients as on the stacked path."""
    loss, met, jloss, jmet, grads = _run_both(name, 2, 8, dtype="float32",
                                              scan_layers=False)
    assert any(k.startswith("blocks/0/mlp/") for k, _, _ in grads)
    assert any(k.startswith("blocks/1/moe/") for k, _, _ in grads)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(jmet["aux"]), rtol=1e-5)
    for k, g, jg in grads:
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# init and support
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [KIMI, DEEPSEEK])
def test_init_tree_matches_jax_and_converter_round_trips(name):
    """Keys, shapes and dtypes of the port's own init equal the JAX
    pytree's leaves (the router float32 in a bfloat16 model);
    params -> numpy -> params is the identity; the init is seeded."""
    jcfg, cfg = _cfgs(name, "bfloat16")
    jflat = dict(T.leaves_with_paths(jax.tree.map(
        np.asarray, J.init_fn(jcfg)(jax.random.PRNGKey(0)))))
    params = api.init_fn(cfg, "cpu")(0)
    flat = dict(T.leaves_with_paths(params))
    assert sorted(flat) == sorted(jflat)
    assert "prefix/0/mlp/w_up" in flat
    assert "layers/moe/experts/w_up" in flat
    for k, p in flat.items():
        assert tuple(p.shape) == jflat[k].shape, k
        assert str(p.dtype)[6:] == str(jflat[k].dtype), k
        assert p.requires_grad, k
    back = api.params_from_jax(api.params_to_numpy(params), "cpu")
    assert isinstance(back["prefix"], list)
    for (k, a), (_, b) in zip(T.leaves_with_paths(params),
                              T.leaves_with_paths(back)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), k
    again = api.init_fn(cfg, "cpu")(0)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params),
                                                  T.leaves(again)))


def test_expert_leaves_are_drawn_expert_by_expert():
    """Each expert of an (E, d, f) leaf has dense_init's scale 1/sqrt(d)
    over its own draw, and the whole leaf is never drawn at once."""
    cfg = ARCHS[KIMI].reduced(dtype="float32", n_experts=16,
                              d_ff_expert=256)
    sizes = []
    real = torch.randn

    def spy(*a, **kw):
        out = real(*a, **kw)
        sizes.append(out.numel())
        return out

    torch.randn = spy
    try:
        p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    finally:
        torch.randn = real
    assert max(sizes) == cfg.d_model * cfg.d_ff_expert
    w = p["experts"]["w_up"]
    assert w.shape == (16, cfg.d_model, 256)
    std = w.reshape(16, -1).std(1)
    assert float((std * cfg.d_model ** 0.5 - 1).abs().max()) < 0.05
    assert not torch.equal(w[0], w[1])


@pytest.mark.parametrize("name", [KIMI, DEEPSEEK])
def test_moe_configs_are_supported(name):
    """The published configs take ``input_specs`` (on the meta device, no
    allocation); the reduced ones run ``init_fn``, ``prefill_fn``,
    ``decode_fn`` and ``loss_fn``."""
    spec = api.input_specs(ARCHS[name], api.SHAPES["prefill_32k"],
                           device="meta")
    assert tuple(spec["tokens"].shape) == (32, 32_768)
    cfg = ARCHS[name].reduced(dtype="float32")
    params = api.init_fn(cfg, "cpu")(0)
    _, tt = _tokens(cfg, 2, 6, 0)
    loss, met = api.loss_fn(cfg)(params, {"tokens": tt, "labels": tt})
    assert torch.isfinite(loss) and float(met["aux"].detach()) > 0
    with torch.no_grad():
        logits, caches = api.prefill_fn(cfg)(params, {"tokens": tt})
        assert len(caches["prefix"]) == cfg.moe_dense_prefix
        cache = api.init_caches(cfg, 2, 8, "cpu")
        out, _ = api.decode_fn(cfg)(params, cache, tt[:, :1], 0)
    assert torch.isfinite(logits).all() and torch.isfinite(out).all()
