"""The port's MLA (multi-head latent attention, minicpm3) on the CPU vs the
JAX package's.

minicpm3-4b ``reduced()``: 2 layers, d_model 64, 4 heads, latent rank 32,
keys 16 + 8 wide, values 16; the key width 24 differs from d_model /
n_heads = 16, so a scale taken from ``cfg.hd`` breaks parity. JAX weights
cross with ``params_from_jax`` and the same numpy inputs go through both.
Float32 is held to rtol 1e-5 (the forward pieces and logits, with an atol
of 1e-5 times the largest value where entries cross zero); loss and
gradients at the dense family's tolerances (``tests/test_torch_model.py``:
float32 loss rtol 1e-5, gradients rtol 1e-4 atol 1e-6; bfloat16 loss rtol
2e-2, gradients 0.1 of each leaf's largest); serving logits and caches as
``tests/test_torch_serve.py`` holds them (float32 1e-5, bfloat16 2e-2,
each with an atol of that share of the largest value). The prefill runs
the flash kernel's plain version, the absorbed decode the latent decode
kernel's (``ref.flash_mla_decode_torch``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import api as J
from repro.models import attention as J_attn
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import train
from repro_torch.models import api, attention, transformer

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NAME = "minicpm3-4b"


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


def _cfgs(dtype="float32", name=NAME, **kw):
    return (J_ARCHS[name].reduced(dtype=dtype, **kw),
            ARCHS[name].reduced(dtype=dtype, **kw))


def _models(dtype="float32", seed=0, name=NAME, **kw):
    jcfg, cfg = _cfgs(dtype, name, **kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _attn(dtype="float32", seed=3):
    """One MLA layer's JAX weights and the same weights in the port."""
    jcfg, cfg = _cfgs(dtype)
    jp = J_attn.init_mla(jax.random.PRNGKey(seed), jcfg)
    p = api.caches_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p


def _x(cfg, b, t, seed=0):
    x = np.random.default_rng(seed).normal(size=(b, t, cfg.d_model))
    return (jnp.asarray(x, cfg.dtype),
            torch.as_tensor(x, dtype=getattr(torch, cfg.dtype)))


def _tokens(cfg, b, t, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, t))
    return jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)


def test_reduced_key_width_differs_from_hd():
    _, cfg = _cfgs()
    assert cfg.qk_nope_dim + cfg.qk_rope_dim == 24 and cfg.hd == 16
    assert attention._mla_scale(cfg) != attention._scale(cfg.hd)


def test_mla_q_and_latent_match_jax():
    jcfg, cfg, jp, p = _attn()
    jx, x = _x(cfg, 2, 12)
    jpos, pos = jnp.arange(12), torch.arange(12)
    for got, want in zip(attention._mla_q(p, x, cfg, pos),
                         J_attn._mla_q(jp, jx, jcfg, jpos)):
        assert tuple(got.shape) == want.shape
        _close(got, want, "float32")
    for got, want in zip(attention._mla_latent(p, x, cfg, pos),
                         J_attn._mla_latent(jp, jx, jcfg, jpos)):
        assert tuple(got.shape) == want.shape
        _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,causal", [(2, 40, True), (2, 40, False),
                                        (1, 4096, True)])
def test_mla_forward_train_matches_jax(dtype, b, t, causal):
    """Both branches of the train forward: the two-einsum scores (T <
    2048) and ``sdpa_blocked`` over the concatenated keys (T = 4096, 2 x 2
    tiles of 2048)."""
    jcfg, cfg, jp, p = _attn(dtype)
    assert (attention._pick_block(t, t) is not None) == (t >= 2048)
    jx, x = _x(cfg, b, t)
    jout, jc = J_attn.mla_forward(jp, jx, jcfg, causal=causal)
    out, c = attention.mla_forward(p, x, cfg, causal=causal)
    assert out.dtype == x.dtype and tuple(out.shape) == jout.shape
    _close(out, jout, dtype, "out")
    for k in ("ckv", "kr"):
        _close(c[k], jc[k], dtype, k)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_prefill_mode_equals_train_mode(causal):
    """``mode="prefill"`` (the flash kernel's plain version over the
    concatenated keys, the values a strided view) against ``"train"`` on
    the CPU, float32."""
    _, cfg, _, p = _attn()
    _, x = _x(cfg, 2, 40, 1)
    out, c = attention.mla_forward(p, x, cfg, causal, mode="prefill")
    want, wc = attention.mla_forward(p, x, cfg, causal, mode="train")
    torch.testing.assert_close(out, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert all(torch.equal(c[k], wc[k]) for k in ("ckv", "kr"))
    with pytest.raises(ValueError, match="train or prefill"):
        attention.mla_forward(p, x, cfg, mode="decode")


def _loss_both(dtype, b, t, seed=0, name=NAME, **kw):
    jcfg, cfg, jparams, params = _models(dtype, seed, name, **kw)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, t + 1))
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]),
          "labels": torch.as_tensor(toks[:, 1:])}
    (jloss, _), jgrads = jax.value_and_grad(J.loss_fn(jcfg), has_aux=True)(
        jparams, jb)
    loss, _ = api.loss_fn(cfg)(params, tb)
    named = list(T.leaves_with_paths(params))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    return loss, jloss, [(k, g, jflat[k]) for (k, _), g in zip(named, grads)]


@pytest.mark.parametrize("b,t", [(2, 16), (1, 4096)])
def test_loss_and_grads_match_f32(b, t):
    loss, jloss, grads = _loss_both("float32", b, t)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert sorted(k for k, _, _ in grads) == sorted(
        ["layers/attn/" + n for n in ("w_dq", "q_norm", "w_uq", "w_dkv",
                                      "kv_norm", "w_ukv", "w_o")]
        + ["embed_tokens", "final_norm/scale", "layers/ln1/scale",
           "layers/ln2/scale", "layers/mlp/w_down", "layers/mlp/w_gate",
           "layers/mlp/w_up"])
    for k, g, jg in grads:
        assert g.dtype == torch.float32 and tuple(g.shape) == jg.shape, k
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_loss_and_grads_match_bf16():
    loss, jloss, grads = _loss_both("bfloat16", 2, 16)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-2)
    for k, g, jg in grads:
        assert g.dtype == torch.bfloat16, k
        scale = float(np.abs(_f32(jg)).max())
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=0,
                                   atol=0.1 * scale + 1e-30, err_msg=k)


@pytest.mark.parametrize("name", [NAME, "qwen3-32b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_remat_is_bitwise_no_remat(name, dtype):
    """The stacked path checkpoints each layer in training (as JAX's scan
    body): loss and every gradient equal, bit for bit, to no remat; the
    backward recomputes each layer's forward once."""
    cfg = ARCHS[name].reduced(dtype=dtype)
    assert cfg.remat and transformer.uses_scan(cfg)
    params = api.init_fn(cfg, "cpu")(0)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = []
    real = transformer.block_forward

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        calls.clear()
        transformer.block_forward = counted
        try:
            loss, _ = api.loss_fn(c)(params, batch)
            grads = torch.autograd.grad(loss, T.leaves(params))
        finally:
            transformer.block_forward = real
        out[remat] = (loss.detach(), grads, len(calls))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1],
                                                 out[False][1]))
    assert out[False][2] == cfg.n_layers
    assert out[True][2] == 2 * cfg.n_layers


def _caches_close(got, want, dtype, what):
    g = dict(T.leaves_with_paths(api.caches_to_numpy(got)))
    w = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
    assert sorted(g) == sorted(w) == ["layers/ckv", "layers/kr"], (g, w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        _close(torch.from_numpy(np.asarray(g[k], np.float32)), w[k], dtype,
               f"{what} {k}")


@pytest.mark.parametrize("absorb", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_match_jax(dtype, absorb):
    """Prefill of a (2, 12) prompt, then 8 decode steps from zero caches
    fed the prompt's tokens: logits and latent caches against JAX at each
    step, absorbed (the latent decode) and materialised (the split decode
    on keys 24 wide and values 16)."""
    jcfg, cfg, jparams, params = _models(dtype, decode_absorb=absorb)
    jt, tt = _tokens(cfg, 2, 12, 1)
    jl, jc = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, pc = api.prefill_fn(cfg)(params, {"tokens": tt})
    assert pl.shape == (2, 1, cfg.padded_vocab) and pc["prefix"] == []
    _close(pl, jl, dtype, "prefill logits")
    _caches_close(pc, jc, dtype, "prefill")
    jstep = jax.jit(J.decode_fn(jcfg))
    jcache = J.init_caches(jcfg, 2, 16)
    cache = api.init_caches(cfg, 2, 16, "cpu")
    assert cache["layers"]["ckv"].shape == (cfg.n_layers, 2, 16,
                                            cfg.kv_lora_rank)
    assert cache["layers"]["kr"].shape == (cfg.n_layers, 2, 16,
                                           cfg.qk_rope_dim)
    ptrs = [x.data_ptr() for x in T.leaves(cache)]
    for t in range(8):
        jlog, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.int32(t))
        with torch.no_grad():
            log, out = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
        assert out is cache
        _close(log, jlog, dtype, f"decode logits, step {t}")
    assert [x.data_ptr() for x in T.leaves(cache)] == ptrs
    _caches_close(cache, jcache, dtype, "decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_equals_materialized(dtype):
    """JAX's ``test_mla_decode_absorbed_equals_materialized`` (run there
    on deepseek-v2), held on minicpm3 in the port: the same weights,
    caches and token through both decode paths."""
    _, cfg, _, params = _models(dtype)
    _, tt = _tokens(cfg, 2, 10, 5)
    logits = []
    for absorb in (True, False):
        c = dataclasses.replace(cfg, decode_absorb=absorb)
        cache = api.init_caches(c, 2, 12, "cpu")
        with torch.no_grad():
            for t in range(10):
                log, _ = api.decode_fn(c)(params, cache, tt[:, t:t + 1], t)
        logits.append(log)
    _close(logits[0], logits[1].float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_token_by_token_equals_prefill(dtype):
    """Decoding a sequence token by token from zero caches gives, at every
    position, the logits of one prefill of the whole sequence."""
    _, cfg, _, params = _models(dtype, seed=2)
    _, tt = _tokens(cfg, 2, 14, 2)
    with torch.no_grad():
        full, _, _ = transformer.forward(params, {"tokens": tt}, cfg,
                                         mode="prefill")
        cache = api.init_caches(cfg, 2, 14, "cpu")
        for t in range(14):
            log, _ = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
            _close(log[:, 0, :cfg.vocab], full[:, t, :cfg.vocab].float()
                   .numpy(), dtype, f"position {t}")


def test_scale_from_hd_breaks_parity(monkeypatch):
    """A scale taken from ``cfg.hd`` (1/4 here) instead of the key width
    (1/sqrt(24)) must break parity with JAX in train, prefill and decode."""
    jcfg, cfg, jparams, params = _models()
    jt, tt = _tokens(cfg, 2, 12, 1)
    monkeypatch.setattr(attention, "_mla_scale",
                        lambda c: attention._scale(c.hd))
    jl, _ = J.prefill_fn(jcfg)(jparams, {"tokens": jt})
    with torch.no_grad():
        pl, _ = api.prefill_fn(cfg)(params, {"tokens": tt})
    with pytest.raises(AssertionError):
        _close(pl, jl, "float32")
    batch = {"tokens": tt[:, :-1], "labels": tt[:, 1:]}
    jloss, _ = J.loss_fn(jcfg)(jparams, {"tokens": jt[:, :-1],
                                         "labels": jt[:, 1:]})
    loss, _ = api.loss_fn(cfg)(params, batch)
    assert abs(float(loss.detach()) - float(jloss)) > 1e-5 * float(jloss)
    jcache = J.init_caches(jcfg, 2, 16)
    cache = api.init_caches(cfg, 2, 16, "cpu")
    for t in range(4):
        jlog, jcache = J.decode_fn(jcfg)(jparams, jcache, jt[:, t:t + 1],
                                         jnp.int32(t))
        with torch.no_grad():
            log, _ = api.decode_fn(cfg)(params, cache, tt[:, t:t + 1], t)
    with pytest.raises(AssertionError):
        _close(log, jlog, "float32")


@pytest.mark.parametrize("b,n,h,r,rd", [(2, 1, 4, 32, 8), (2, 77, 4, 32, 8),
                                        (1, 300, 40, 256, 32),
                                        (4, 2112, 40, 256, 32)])
def test_plain_mla_decode_equals_sdpa(b, n, h, r, rd):
    """``flash_mla_decode_torch`` (the kernel's split-and-merge order, the
    splits the kernel takes) equals ``sdpa`` over the concatenated keys and
    the JAX absorbed decode's arithmetic (scores ``q_lat . ckv + q_rope .
    kr`` summed, then scaled) in float32, within rtol = atol = 1e-5 (the
    sums over 256 columns and up to 2,112 keys run in other orders)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        mla_splits)
    rng = np.random.default_rng(n)
    q_lat, q_rope = (rng.normal(size=(b, 1, h, w)).astype(np.float32)
                     for w in (r, rd))
    ckv, kr = (rng.normal(size=(b, n, w)).astype(np.float32)
               for w in (r, rd))
    tq = [torch.from_numpy(a) for a in (q_lat, q_rope, ckv, kr)]
    got = ref.flash_mla_decode_torch(*tq, 0.1, mla_splits(b, h, n))
    assert got.shape == (b, 1, h, r)
    want = ref.sdpa(torch.cat(tq[:2], -1), ref.mla_keys(tq[2], tq[3]),
                    tq[2][:, :, None], None, 0.1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    logits = (jnp.einsum("bthr,bsr->bhts", q_lat, ckv)
              + jnp.einsum("bthd,bsd->bhts", q_rope, kr)) * 0.1
    jout = jnp.einsum("bhts,bsr->bthr", jax.nn.softmax(logits, -1), ckv)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,t,s,h,hkv,d,dv,causal", [
    (2, 40, 40, 4, 4, 96, 64, True), (1, 300, 300, 2, 2, 96, 64, True),
    (2, 37, 101, 4, 2, 96, 64, False), (2, 1, 77, 4, 1, 24, 16, False),
    (1, 1, 1000, 8, 2, 96, 64, False)])
def test_plain_versions_take_narrow_values(b, t, s, h, hkv, d, dv, causal):
    """The plain versions with Dv < D equal the JAX model's ``sdpa`` on the
    same inputs: ``flash_attention_gqa_torch`` (float32), the split decode's
    twin (T = 1, float32) and the tensor-core tile's twin (bfloat16
    inputs, within the bfloat16 rounding of its weights)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        DECODE_HEADS, decode_splits)
    rng = np.random.default_rng(t + s)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv)).astype(np.float32)
    mask = (J_attn.causal_mask(t, s)[None] if causal
            else jnp.ones((1, t, s), bool))
    want = np.asarray(J_attn.sdpa(q, k, v, mask, 0.125))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_gqa_torch(tq, tk, tv, 0.125, causal)
    assert got.shape == (b, t, h, dv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if t == 1:
        n_split = decode_splits(s, b * hkv * -(-(h // hkv) // DECODE_HEADS))
        np.testing.assert_allclose(
            ref.flash_decode_split_torch(tq, tk, tv, 0.125, n_split).numpy(),
            want, rtol=1e-5, atol=1e-6)
        return
    bq, bk, bv = (x.to(torch.bfloat16) for x in (tq, tk, tv))
    tc = ref.flash_attention_tc_torch(bq, bk, bv, 0.125, causal)
    assert tc.shape == (b, t, h, dv) and tc.dtype == torch.bfloat16
    f32 = ref.flash_attention_gqa_torch(bq.float(), bk.float(), bv.float(),
                                        0.125, causal)
    a32 = ref.flash_attention_gqa_torch(bq.float(), bk.float(),
                                        bv.float().abs(), 0.125, causal)
    lim = 2.0 ** -8 * f32.abs() + (2.0 ** -8 + 2.0 ** -15) * a32 + 2.0 ** -15
    assert float(((tc.float() - f32).abs() / lim).max()) <= 1.0


def test_init_tree_and_caches_match_jax():
    """The port's own init has the JAX tree's leaves (keys, shapes,
    dtypes); its caches the JAX caches' leaves."""
    jcfg, cfg = _cfgs("bfloat16")
    jflat = dict(T.leaves_with_paths(jax.tree.map(
        np.asarray, J.init_fn(jcfg)(jax.random.PRNGKey(0)))))
    flat = dict(T.leaves_with_paths(api.init_fn(cfg, "cpu")(0)))
    assert sorted(flat) == sorted(jflat)
    for k, p in flat.items():
        assert tuple(p.shape) == jflat[k].shape, k
        assert str(p.dtype)[6:] == str(jflat[k].dtype), k
    jc = dict(T.leaves_with_paths(jax.tree.map(
        np.asarray, J.init_caches(jcfg, 3, 20))))
    c = dict(T.leaves_with_paths(api.caches_to_numpy(
        api.init_caches(cfg, 3, 20, "cpu"))))
    assert sorted(c) == sorted(jc)
    for k in c:
        assert c[k].shape == jc[k].shape and str(c[k].dtype) == str(
            jc[k].dtype), k
    spec = attention.mla_cache_spec(cfg, 3, 20, "cpu")
    jspec = J_attn.mla_cache_spec(jcfg, 3, 20)
    assert {k: tuple(v.shape) for k, v in spec.items()} == {
        k: v.shape for k, v in jspec.items()}


def test_input_specs_and_decode_position_checks():
    _, cfg = _cfgs()
    batch = api.input_specs(cfg, api.ShapeSpec("t", 16, 2, "train"),
                            device="cpu")
    assert sorted(batch) == ["labels", "tokens"]
    _, cfg, _, params = _models()
    cache = api.init_caches(cfg, 2, 4, "cpu")
    with pytest.raises(ValueError, match="outside a cache of 4"):
        api.decode_fn(cfg)(params, cache, torch.zeros((2, 1), dtype=int), 4)


def test_trainer_trains_minicpm3_on_the_cpu():
    """``launch/train.py`` on reduced minicpm3, 2 workers, top-k 1%:
    finite losses, the same from the same seed."""
    args = ["--arch", NAME, "--reduced", "--device", "cpu", "--n-dev", "2",
            "--compress", "topk:0.01", "--steps", "3", "--seq", "16",
            "--log-every", "100"]
    losses = train.main(args)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert abs(losses[0] - np.log(ARCHS[NAME].reduced().vocab)) < 1.0
    assert train.main(args) == losses


def test_dispatch_paths_and_refusals():
    """The kernel each call takes (tensor-core tile for bfloat16 (96, 64),
    not for square 96), the latent decode's shape checks (the plain
    version refuses inputs that do not fit together and computes at any
    widths; the kernels' launcher refuses widths past theirs), and the
    CUDA wrapper refusing CPU tensors without counting a launch."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ops import flash_mla_decode
    bf = torch.bfloat16
    assert FA.path_of(torch.zeros(2, 9, 4, 96, dtype=bf), 64) == "tile_tc"
    assert FA.path_of(torch.zeros(2, 9, 4, 96, dtype=bf)) == "tile_simt"
    assert FA.path_of(torch.zeros(2, 9, 4, 96), 64) == "tile_simt"
    assert FA.path_of(torch.zeros(2, 1, 4, 96, dtype=bf), 64) == \
        "decode_split"
    ql, qr = torch.zeros(2, 1, 4, 32), torch.zeros(2, 1, 4, 8)
    ckv, kr = torch.zeros(2, 5, 32), torch.zeros(2, 5, 8)
    assert FA.mla_geometry(ql, qr, ckv, kr) == (2, 5, 4, 32, 8)
    for bad in ((ql, qr, ckv[..., :24], kr),
                (ql, qr[..., :4], ckv, kr),
                (torch.zeros(2, 2, 4, 32), qr, ckv, kr)):
        with pytest.raises(ValueError, match="flash_mla_decode"):
            flash_mla_decode(*bad, 0.1)
    for wide in ((ql, qr[..., :4], ckv, kr[..., :4]),
                 (torch.zeros(2, 1, 4, 520), qr, torch.zeros(2, 5, 520), kr)):
        with pytest.raises(ValueError, match="multiples of 8"):
            FA.mla_geometry(*wide)
        assert flash_mla_decode(*wide, 0.1).shape == wide[0].shape
    with pytest.raises(TypeError, match="float32/bfloat16"):
        flash_mla_decode(ql.half(), qr.half(), ckv.half(), kr.half(), 0.1)
    before = dict(FA.flash_attention_cuda.launches_by_path)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_mla_decode_cuda(ql, qr, ckv, kr, 0.1)
    flash_mla_decode(ql, qr, ckv, kr, 0.1)
    assert FA.flash_attention_cuda.launches_by_path == before
