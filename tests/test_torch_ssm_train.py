"""Training the hybrid family (hymba) on the CPU: the port against the JAX
package.

* Trees with lists: ``tree.unflatten(flat, like=...)`` keeps hymba's
  ``blocks`` list a list in JAX's order, so ``compress_tree`` and a whole
  ``TrainStep`` take a ``{"blocks": [...]}`` tree as JAX's
  ``jax.tree.map`` does.
* The scan's backward: the plain ``ssm_chunk_scan_bwd_torch`` against
  ``torch.autograd`` through the plain forward in float64 (rtol 1e-10:
  the same sums in another order) and against ``jax.vjp`` of
  ``ssm_chunk_scan_ref`` on the JAX test shapes in float32 (each
  gradient within 1e-5 of its largest value, the forward tests' 1e-5
  scaled to a sum over up to 64 steps); ``SSMScan`` under
  ``torch.autograd.gradcheck`` in float64.
* Mamba heads and the whole reduced hymba ``loss_fn``: every gradient
  against ``jax.grad``. Float32 at ``tests/test_ssm_chunked.py``'s rtol
  2e-4 with its atol scaled to each leaf (2e-4 of the leaf's largest
  |gradient|: a leaf's gradient is a sum over every (b, t), and a
  per-element atol of 2e-5 means nothing for gradients of 1e-6). In
  bfloat16 JAX's gradients are themselves far from the truth (``dt_bias``
  is a sum that cancels to a few bfloat16 ulps), so each leaf is held to
  the float32 JAX gradient on the same parameters: the port's error at
  most 2 x JAX's own bfloat16 error plus 5e-2 of the leaf's largest
  |gradient| (JAX's own bfloat16 errors reach 17% of that on ``dt_bias``
  and 5% elsewhere, seeds 0-3 of the reduced models). Remat changes no
  bit.
* ``main --arch hymba-1.5b --reduced --device cpu`` trains and resumes
  bitwise.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.collectives import build_program as j_build_program
from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels.ssm_scan.ref import ssm_chunk_scan_ref
from repro.launch import train as J_train
from repro.models import api as J
from repro.models import ssm as J_ssm
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (ssm_chunk_scan_bwd_torch,
                                              ssm_chunk_scan_torch)
from repro_torch.launch import train
from repro_torch.models import api, ssm, transformer
from repro_torch.optim import adamw, compression

JAX_SHAPES = [(1, 16, 8, 4), (2, 32, 16, 4), (3, 64, 24, 8), (2, 32, 16, 32),
              (2, 1, 8, 16), (2, 13, 12, 16)]
NAMES = ("gu", "gdelta", "gbv", "gcv", "ga", "gs0")
F32 = {"rtol": 2e-4, "leaf_atol": 2e-4}


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


def _inputs(seed, b, t, d, n, strided=False):
    """numpy u, delta, bv, cv, a, s0 as the JAX test draws them, gy and
    gs_final; bv and cv as slices of one (B, T, 2N + 1) array if
    ``strided``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    delta = np.log1p(np.exp(f(b, t, 1) - 2)).astype(np.float32)
    a = -np.exp(f(d, n) * 0.3).astype(np.float32)
    if strided:
        proj = f(b, t, 2 * n + 1)
        bv, cv = proj[..., :n], proj[..., n:2 * n]
    else:
        bv, cv = f(b, t, n), f(b, t, n)
    return f(b, t, d), delta, bv, cv, a, f(b, d, n), f(b, t, d), f(b, d, n)


def _leaf_close(got, want, path, rtol=F32["rtol"], leaf_atol=F32["leaf_atol"]):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=leaf_atol * float(np.abs(want).max()),
                               err_msg=path)


# ---------------------------------------------------------------------------
# trees with lists
# ---------------------------------------------------------------------------

def test_unflatten_keeps_lists_in_like_order():
    like = {"blocks": [{"w": torch.zeros(1), "s": {"a": torch.zeros(2)}}
                       for _ in range(12)], "e": torch.zeros(3)}
    flat = {p: torch.full(tuple(x.shape), float(i))
            for i, (p, x) in enumerate(T.leaves_with_paths(like))}
    back = T.unflatten(flat, like=like)
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 12
    assert [p for p, _ in T.leaves_with_paths(back)] == list(flat)
    assert all(a is b for a, b in zip(T.leaves(back), flat.values()))
    assert back["blocks"][10]["s"]["a"] is flat["blocks/10/s/a"]
    # without a template every level is a dict, keyed by the path's parts
    assert set(T.unflatten(flat)["blocks"]) == {str(i) for i in range(12)}


@pytest.mark.parametrize("spec", ["topk:0.1", "int8"])
def test_compress_tree_keeps_the_blocks_list_like_jax(spec):
    """``compress_tree`` on a 12-block hymba-shaped gradient tree: JAX's
    structure (the list, JAX's leaf order) and JAX's values, bit for bit."""
    cfg = J_ARCHS["hymba-1.5b"].reduced(dtype="float32", n_layers=12,
                                        d_model=16, n_heads=2, d_ff=32,
                                        head_dim=8)
    jg = J.init_fn(cfg)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    jef = jax.tree.map(lambda a: jnp.asarray(rng.normal(
        size=a.shape).astype(np.float32) * 0.1), jg)
    jsent, jnew = j_comp.compress_tree(jg, jef, j_comp.CompressionConfig.parse(
        spec))
    g = api.params_from_jax(jax.tree.map(np.asarray, jg), "cpu")
    ef = api.caches_from_jax(jax.tree.map(np.asarray, jef), "cpu")
    sent, new = compression.compress_tree(
        g, ef, compression.CompressionConfig.parse(spec))
    for got, want in ((sent, jsent), (new, jnew)):
        assert isinstance(got["blocks"], list) and len(got["blocks"]) == 12
        want = jax.tree.map(np.asarray, want)
        paths = [p for p, _ in T.leaves_with_paths(got)]
        assert paths == [p for p, _ in T.leaves_with_paths(want)]
        for p, a, b in zip(paths, T.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=p)


def test_whole_train_step_on_a_hymba_blocks_tree_matches_jax_make_step():
    """One worker, top-k compression, 12 hybrid blocks (``blocks/10``
    sorts before ``blocks/2`` as a string): two steps of the port's
    ``TrainStep`` against the JAX ``make_step`` (loss rtol 1e-5, params at
    ``tests/test_torch_train.py``'s tolerances)."""
    kw = dict(dtype="float32", n_layers=12, d_model=32, n_heads=2, d_ff=64,
              head_dim=16)
    jcfg = J_ARCHS["hymba-1.5b"].reduced(**kw)
    cfg = ARCHS["hymba-1.5b"].reduced(**kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(1))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jtopo = J_train.dp_fleet(1)
    jprog = j_build_program(jtopo, np.zeros(jtopo.tree.n, bool))
    prog = train.orchestrator(1, 2, device="cpu").program
    jocfg, ocfg = j_adamw.AdamWConfig(), adamw.AdamWConfig()
    jccfg = j_comp.CompressionConfig.parse("topk:0.1")
    ccfg = compression.CompressionConfig.parse("topk:0.1")
    jstep = J_train.make_step(jcfg, jocfg, None, jprog, 1.0, jccfg)
    step = train.make_step(cfg, ocfg, prog, 1.0, ccfg)
    jstate = (jparams, j_adamw.init(jparams, jocfg),
              jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                           jparams))
    state = (params, adamw.init(params, ocfg),
             compression.init_error_feedback(params))
    jdata = JSyntheticLM(jcfg, JDataConfig(2, 16, seed=3))
    data = SyntheticLM(cfg, DataConfig(2, 16, seed=3), device="cpu")
    for s in range(2):
        *jstate, jmet = jstep(*jstate, jdata.batch(s))
        *state, met = step(*state, data.batch(s))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    assert isinstance(state[0]["blocks"], list)
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jstate[0])))
    for k, p in T.leaves_with_paths(state[0]):
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=1e-4,
                                   atol=0.1 * ocfg.lr, err_msg=k)


# ---------------------------------------------------------------------------
# the scan's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_gs", [True, False])
@pytest.mark.parametrize("b,t,d,n", JAX_SHAPES)
def test_plain_backward_matches_autograd_in_float64(b, t, d, n, with_gs):
    xs = [torch.from_numpy(x).double() for x in _inputs(
        b * 7 + t, b, t, d, n, strided=n == 16)]
    ins, gy, gs = xs[:6], xs[6], xs[7] if with_gs else None
    leaves = [x.detach().clone().requires_grad_() for x in ins]
    y, s = ssm_chunk_scan_torch(*leaves)
    out = (y * gy).sum() + ((s * gs).sum() if with_gs else 0.0)
    want = torch.autograd.grad(out, leaves)
    got = ssm_chunk_scan_bwd_torch(*ins, gy, gs)
    for name, g, w, x in zip(NAMES, got, want, ins):
        assert g.shape == x.shape and g.dtype == torch.float64, name
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10 * float(
            w.abs().max()), msg=name)


@pytest.mark.parametrize("b,t,d,n", JAX_SHAPES)
def test_plain_backward_matches_jax_vjp_of_the_reference(b, t, d, n):
    xs = _inputs(b * 11 + t, b, t, d, n, strided=n == 16)
    _, vjp = jax.vjp(ssm_chunk_scan_ref, *map(jnp.asarray, xs[:6]))
    want = vjp((jnp.asarray(xs[6]), jnp.asarray(xs[7])))
    got = ssm_chunk_scan_bwd_torch(*map(torch.from_numpy, xs))
    for name, g, w in zip(NAMES, got, want):
        _leaf_close(g, w, name, rtol=1e-5, leaf_atol=1e-5)


def test_ssm_scan_function_passes_gradcheck():
    """``SSMScan`` on CPU tensors in float64, all six inputs, bv and cv as
    strided views of one projection, both outputs used."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s))
    proj = f(2, 5, 9).requires_grad_()
    u, s0 = f(2, 5, 3).requires_grad_(), f(2, 3, 4).requires_grad_()
    delta = torch.nn.functional.softplus(f(2, 5, 1) - 2).requires_grad_()
    a = (-torch.exp(f(3, 4) * 0.3)).requires_grad_()

    def fn(u, delta, proj, a, s0):
        return ops.SSMScan.apply(u, delta, proj[..., :4], proj[..., 4:8], a,
                                 s0)

    assert torch.autograd.gradcheck(fn, (u, delta, proj, a, s0))


def test_dispatch_takes_the_autograd_function_only_under_grad():
    xs = [torch.from_numpy(x) for x in _inputs(1, 2, 9, 8, 4)[:6]]
    y, s = ops.ssm_chunk_scan(*xs)
    assert y.grad_fn is None
    u = xs[0].clone().requires_grad_()
    y, s = ops.ssm_chunk_scan(u, *xs[1:])
    assert type(y.grad_fn).__name__ == "SSMScanBackward"
    with torch.no_grad():
        assert ops.ssm_chunk_scan(u, *xs[1:])[0].grad_fn is None
    with pytest.raises(ValueError, match="inference only"):
        ops.ssm_chunk_scan(u, *xs[1:], s_out=xs[5].clone())


# ---------------------------------------------------------------------------
# Mamba heads and the whole reduced hymba
# ---------------------------------------------------------------------------

def _mamba(seed=0):
    jcfg = J_ARCHS["hymba-1.5b"].reduced(chunk_size=8, dtype="float32")
    cfg = ARCHS["hymba-1.5b"].reduced(chunk_size=8, dtype="float32")
    jp = J_ssm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    # a_log, d_skip and dt_bias start constant; draw them so that every
    # gradient is exercised
    rng = np.random.default_rng(seed)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3
                          + np.asarray(v)) if k in ("a_log", "d_skip",
                                                    "dt_bias") else v)
          for k, v in jp.items()}
    return jcfg, cfg, jp, api.params_from_jax(jax.tree.map(np.asarray, jp),
                                              "cpu")


@pytest.mark.parametrize("t", [32, 12, 1])
def test_mamba_gradients_match_jax(t):
    """Every parameter's gradient and x's against ``jax.grad`` of JAX's
    ``mamba_forward`` (chunked at T = 32, sequential at 12 and 1) under
    the loss sum(y * w); the final state's gradient flows too.
    ``dt_bias[1:]`` gets exact zeros, as in JAX."""
    jcfg, cfg, jp, p = _mamba(t)
    rng = np.random.default_rng(t + 1)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    ws = rng.normal(size=(2, 128, cfg.ssm_state)).astype(np.float32)

    def jloss(jp, x):
        y, st = J_ssm.mamba_forward(jp, x, jcfg)
        return jnp.sum(y * w) + jnp.sum(st["s"] * ws)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, st = ssm.mamba_forward(p, xt, cfg)
    loss = (y * torch.from_numpy(w)).sum() + (st["s"] * torch.from_numpy(
        ws)).sum()
    names = sorted(p)
    got = torch.autograd.grad(loss, [p[k] for k in names] + [xt])
    for k, g in zip(names, got):
        _leaf_close(g, jgp[k], k)
    _leaf_close(got[-1], jgx, "x")
    assert torch.equal(got[names.index("dt_bias")][1:],
                       torch.zeros(127))


def _hymba(dtype, seed=0, **kw):
    kw = dict(dtype=dtype, chunk_size=8, **kw)
    jcfg = J_ARCHS["hymba-1.5b"].reduced(**kw)
    cfg = ARCHS["hymba-1.5b"].reduced(**kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, api.params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _batches(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, t + 1))
    return ({"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
             "labels": jnp.asarray(toks[:, 1:], jnp.int32)},
            {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])})


def _port_grads(cfg, params, batch):
    loss, met = api.loss_fn(cfg)(params, batch)
    return loss.detach(), torch.autograd.grad(loss, T.leaves(params))


@pytest.mark.parametrize("case", [
    dict(t=64), dict(t=44), dict(t=512, sliding_window=256)])
def test_loss_and_every_gradient_match_jax_float32(case):
    """Float32: the loss at rtol 1e-5 and every leaf's gradient against
    ``jax.grad`` of JAX's ``loss_fn``; T = 44 is no multiple of the chunk
    (JAX's sequential scan); a 256-position window at T = 512 takes
    ``sdpa_blocked`` on both sides. The port's remat changes no bit."""
    case = dict(case)
    t = case.pop("t")
    jcfg, cfg, jparams, params = _hymba("float32", **case)
    jb, b = _batches(cfg, 2, t, t)
    (jl, _), jg = jax.value_and_grad(J.loss_fn(jcfg), has_aux=True)(jparams,
                                                                   jb)
    loss, grads = _port_grads(cfg, params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    paths = [p for p, _ in T.leaves_with_paths(params)]
    assert len(paths) == len(jax.tree.leaves(jg))
    for path, g, w in zip(paths, grads, jax.tree.leaves(jg)):
        _leaf_close(g, w, path)
    assert cfg.remat
    l2, g2 = _port_grads(dataclasses.replace(cfg, remat=False), params, b)
    assert torch.equal(loss, l2)
    for path, x, y in zip(paths, grads, g2):
        assert torch.equal(x, y), path


def test_loss_and_every_gradient_match_jax_bfloat16():
    """bfloat16, T = 64: the loss at the serving tests' 2e-2, each leaf
    within 2 x JAX's own bfloat16 error of the float32 JAX gradient on the
    same parameters (plus 5e-2 of the leaf's largest |gradient|); remat
    bitwise."""
    jcfg, cfg, jparams, params = _hymba("bfloat16", seed=2)
    jb, b = _batches(cfg, 2, 64, 3)
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
        ours = np.abs(_np(g) - tr).max()
        theirs = np.abs(_np(w) - tr).max()
        assert ours <= 2 * theirs + 5e-2 * np.abs(tr).max(), (path, ours,
                                                              theirs)
    l2, g2 = _port_grads(dataclasses.replace(cfg, remat=False), params, b)
    assert torch.equal(loss, l2)
    assert all(torch.equal(x, y) for x, y in zip(grads, g2))


def test_remat_checkpoints_each_block_and_recomputes_its_scan(monkeypatch):
    """With remat the scan's forward runs twice a layer (the forward, then
    the recompute in the backward) and its backward once; without, once
    and once."""
    jcfg, cfg, jparams, params = _hymba("float32")
    _, b = _batches(cfg, 2, 16, 0)
    fwd, bwd = [], []
    real_f, real_b = ops.ssm_chunk_scan_torch, ops.ssm_chunk_scan_bwd_torch
    monkeypatch.setattr(ops, "ssm_chunk_scan_torch",
                        lambda *a: fwd.append(1) or real_f(*a))
    monkeypatch.setattr(ops, "ssm_chunk_scan_bwd_torch",
                        lambda *a: bwd.append(1) or real_b(*a))
    for remat, n_fwd in ((True, 4), (False, 2)):
        fwd.clear(), bwd.clear()
        _port_grads(dataclasses.replace(cfg, remat=remat), params, b)
        assert (len(fwd), len(bwd)) == (n_fwd, 2), remat


def test_main_trains_hymba_and_resumes_bitwise(tmp_path, capsys):
    args = ["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
            "--n-dev", "2", "--global-batch", "4", "--seq", "40", "--steps",
            "4", "--compress", "topk:0.05", "--ckpt-every", "2",
            "--log-every", "1"]
    full = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(full) == 4 and np.isfinite(full).all()
    shutil.copytree(tmp_path / "a" / "step_00000002",
                    tmp_path / "b" / "step_00000002")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed == full[2:]
    a = np.load(tmp_path / "a" / "step_00000004" / "arrays.npz")
    b = np.load(tmp_path / "b" / "step_00000004" / "arrays.npz")
    assert sorted(a) == sorted(b)
    assert "params/blocks/1/ssm/a_log" in a and "ef/blocks/0/ssm/w_in" in a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    manifest = (tmp_path / "a" / "step_00000004" / "manifest.json").read_text()
    assert "'blocks': [" in manifest
    restored, _ = ckpt.restore(tmp_path / "a", {"params": api.init_fn(
        ARCHS["hymba-1.5b"].reduced(), "cpu")(0)})
    assert isinstance(restored["params"]["blocks"], list)


def test_input_specs_and_loss_fn_take_the_train_shape():
    cfg = ARCHS["hymba-1.5b"].reduced()
    batch = api.input_specs(cfg, api.SHAPES["train_4k"], device="meta")
    assert batch["tokens"].shape == batch["labels"].shape == (256, 4096)
    assert callable(api.loss_fn(cfg))
    assert transformer._layer_kinds(cfg) == ["hybrid", "hybrid"]
