"""The port's dense transformer on the CPU vs the JAX package's.

The JAX model's parameters (``api.init_fn``) cross to the port by key with
``params_from_jax`` (no transposes), and the same numpy batch goes through
``jax.value_and_grad`` of the JAX ``loss_fn`` and through the port's
``loss_fn`` and autograd. Matrix products and softmax sums run in another
order than XLA's, so float32 is held to loss rtol 1e-5 and gradients rtol
1e-4, atol 1e-6. A bfloat16 model rounds every product and activation to
8 bits, at other places in the two frameworks, so its loss is held to
rtol 2e-2 and its gradients to 0.1 of the largest gradient of each leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import api as J
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.models import api
from repro_torch.models.attention import _pick_block


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    return J_ARCHS[name].reduced(**kw), ARCHS[name].reduced(**kw)


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, t + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int64),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int64)})


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _run_both(name, b, t, seed=0, **kw):
    jcfg, cfg = _cfgs(name, **kw)
    jparams = J.init_fn(jcfg)(jax.random.PRNGKey(seed))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jb, tb = _batch(cfg, b, t, seed)
    (jloss, jmet), jgrads = jax.value_and_grad(J.loss_fn(jcfg), has_aux=True)(
        jparams, jb)
    loss, met = api.loss_fn(cfg)(params, tb)
    named = list(T.leaves_with_paths(params))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    return (loss, met, jloss, jmet,
            [(k, g, jflat[k]) for (k, _), g in zip(named, grads)])


@pytest.mark.parametrize("name,b,t", [
    ("qwen3-32b", 2, 16),      # qk-norm, swiglu, GQA (4 heads over 2)
    ("granite-20b", 2, 16),    # gelu (tanh), MQA
    ("nemotron-4-340b", 2, 16),
    ("qwen3-32b", 1, 4096),    # T = 2 * 2048: sdpa_blocked, 2 x 2 tiles
])
def test_loss_and_grads_match_f32(name, b, t):
    loss, met, jloss, jmet, grads = _run_both(name, b, t, dtype="float32")
    if t >= 2048:
        assert _pick_block(t, t) == 2048
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["nll"].detach()),
                               float(jmet["nll"]), rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    for k, g, jg in grads:
        assert g.dtype == torch.float32 and tuple(g.shape) == jg.shape, k
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_loss_and_grads_match_bf16():
    loss, _, jloss, _, grads = _run_both("qwen3-32b", 2, 16)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=2e-2)
    for k, g, jg in grads:
        assert g.dtype == torch.bfloat16, k
        scale = float(np.abs(_f32(jg)).max())
        np.testing.assert_allclose(_f32(g), _f32(jg), rtol=0,
                                   atol=0.1 * scale + 1e-30, err_msg=k)


@pytest.mark.parametrize("name", ["qwen3-32b", "granite-20b",
                                  "nemotron-4-340b"])
def test_init_tree_matches_jax_and_converter_round_trips(name):
    """Keys, shapes and dtypes of the port's own init equal the JAX
    pytree's leaves; params -> numpy -> params is the identity."""
    jcfg, cfg = _cfgs(name)
    jflat = dict(T.leaves_with_paths(jax.tree.map(
        np.asarray, J.init_fn(jcfg)(jax.random.PRNGKey(0)))))
    params = api.init_fn(cfg, "cpu")(0)
    flat = dict(T.leaves_with_paths(params))
    assert sorted(flat) == sorted(jflat)
    for k, p in flat.items():
        assert tuple(p.shape) == jflat[k].shape, k
        assert str(p.dtype)[6:] == str(jflat[k].dtype), k
        assert p.requires_grad, k
    back = api.params_from_jax(api.params_to_numpy(params), "cpu")
    for (k, a), (_, b) in zip(T.leaves_with_paths(params),
                              T.leaves_with_paths(back)):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), k
    # the port's init is seeded: the same seed, the same values
    again = api.init_fn(cfg, "cpu")(0)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(params),
                                                  T.leaves(again)))


@pytest.mark.parametrize("name", ["llava-next-34b", "whisper-large-v3"])
def test_train_refuses_vlm_and_encdec_naming_the_roadmap(name, monkeypatch):
    """The trainer's data pipeline makes tokens only. The encoder-decoder's
    loss reads audio frames, so ``launch/train.py --arch
    whisper-large-v3`` raises ``ValueError`` naming ROADMAP before it
    builds anything (the JAX trainer fails there too: its
    ``encdec.loss_fn`` reads ``batch["frames"]``). The VLM is not refused:
    it trains text-only, as the JAX trainer trains it, and ``train.main``
    on reduced llava gives the JAX ``train.main``'s losses from the same
    parameters and batches. Both configs are made float32 in both
    packages, so the losses are held to the trainer tests' float32 rtol
    1e-5 (both serve: tests/test_torch_vlm.py, tests/test_torch_encdec.py).
    """
    from repro.launch import train as J_train
    from repro_torch.launch import train
    if name == "whisper-large-v3":
        with pytest.raises(ValueError, match="ROADMAP"):
            train.main(["--arch", name, "--reduced", "--device", "cpu",
                        "--steps", "1"])
        return
    monkeypatch.setitem(J_ARCHS, name, dataclasses.replace(
        J_ARCHS[name], dtype="float32"))
    monkeypatch.setitem(ARCHS, name, dataclasses.replace(
        ARCHS[name], dtype="float32"))
    argv = ["--arch", name, "--reduced", "--steps", "3", "--global-batch",
            "2", "--seq", "32"]
    jlosses = J_train.main(argv)
    jparams = J.init_fn(J_ARCHS[name].reduced())(jax.random.PRNGKey(0))
    monkeypatch.setattr(train.api, "init_fn", lambda cfg, device: (
        lambda seed: api.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         device)))
    losses = train.main(argv + ["--device", "cpu"])
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_configs_are_copies():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[name])
        assert cfg.param_count() == J_ARCHS[name].param_count()
    assert api.SHAPES == {k: api.ShapeSpec(**dataclasses.asdict(v))
                          for k, v in J.SHAPES.items()}
