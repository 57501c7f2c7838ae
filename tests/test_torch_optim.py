"""The port's gradient compression and AdamW on the CPU vs the JAX package's.

``compress_tree`` (top-k and int8, with error feedback over three steps) is
held bit for bit against the JAX function: the same float32 ops in the
same order, ``round`` half to even, one top-k threshold per leaf (also
across the layers of a stacked ``(L, ...)`` leaf). Top-k is also held
against the JAX function under ``jax.jit``, as the JAX training step runs
it. Int8 is not: jitted, XLA may fuse its ops into other roundings (an
FMA for ``g32 - q * scale``, and, at some shapes, a scale one ulp off),
which shifts the last bit (ROADMAP C10). ``payload_bytes`` must be equal.

AdamW sums its global norm in another order than XLA (and XLA may
contract ``b * m + c * g`` into an FMA), so ``global_norm`` is held to
rtol 1e-6, and float32 parameters and moments to rtol 1e-6 (about 2 ulp)
with an atol of 1e-6 times the leaf's largest magnitude (where the moment
update cancels); a bfloat16 parameter or moment may round one bfloat16
ulp apart when the float32 value it rounds from differs in its last bit,
and is held to one ulp of each element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import compression as J
from repro_torch.optim import adamw
from repro_torch.optim import compression as P

SHAPES = {"embed": (64, 24), "layers": {"w": (3, 16, 8), "scale": (3, 8)},
          "bias": (5,)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map(fn, shapes, path=""):
    if isinstance(shapes, dict):
        return {k: _map(fn, v, f"{path}{k}/") for k, v in shapes.items()}
    return fn(path[:-1], shapes)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}{k}/")
    else:
        yield path[:-1], tree


def _to_jax(t: torch.Tensor):
    """A copy (the port updates its tensors in place; a JAX array made
    from their numpy view could share the memory)."""
    if t.dtype == torch.bfloat16:
        return jnp.array(t.view(torch.int16).numpy().view(jnp.bfloat16),
                         copy=True)
    return jnp.array(t.numpy(), copy=True)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _grads(rng, dtype, sparse=False):
    """Random gradients; ``sparse`` zeroes most entries and plants ties."""
    def one(_, shape):
        g = rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 2, shape)
        if sparse:
            g[rng.random(shape) < 0.7] = 0.0
            g[rng.random(shape) < 0.1] = 0.5
        return torch.as_tensor(g, dtype=torch.float32).to(dtype)
    return _map(one, SHAPES)


def _assert_trees_bitwise(port, ref, what):
    for (pa, p), (ja, j) in zip(_leaves(port), _leaves(ref), strict=True):
        assert pa == ja
        assert p.dtype == getattr(torch, str(j.dtype)), (what, pa)
        assert np.array_equal(_bits(p), _bits(j)), (what, pa)


@pytest.mark.parametrize("spec", ["topk:0.1", "topk:0.01", "topk", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sparse", [False, True])
def test_compress_tree_bitwise_over_three_steps(spec, dtype, sparse):
    rng = np.random.default_rng([ord(spec[-1]), len(spec),
                                 dtype == torch.bfloat16, sparse])
    pc, jc = P.CompressionConfig.parse(spec), J.CompressionConfig.parse(spec)
    assert (pc.kind, pc.ratio) == (jc.kind, jc.ratio)
    p_ef = _map(lambda _, s: torch.zeros(s), SHAPES)
    j_ef = J.init_error_feedback(_map(lambda _, s: jnp.zeros(s), SHAPES))
    refs = [J.compress_tree]
    if pc.kind == "topk":
        refs.append(jax.jit(J.compress_tree, static_argnums=2))
    for step in range(3):
        g = _grads(rng, dtype, sparse)
        jg = _map(lambda k, _: _to_jax(dict(_leaves(g))[k]), SHAPES)
        p_sent, p_ef_next = P.compress_tree(g, p_ef, pc)
        for ref in refs:
            j_sent, j_ef_next = ref(jg, j_ef, jc)
            _assert_trees_bitwise(p_sent, j_sent, f"sent step {step}")
            _assert_trees_bitwise(p_ef_next, j_ef_next, f"ef step {step}")
        p_ef, j_ef = p_ef_next, j_ef_next
    params = _map(lambda _, s: torch.zeros(s), SHAPES)
    assert P.payload_bytes(params, pc) == J.payload_bytes(
        _map(lambda _, s: jnp.zeros(s), SHAPES), jc)


def test_stacked_leaf_has_one_threshold():
    """A stacked (L, ...) leaf has one threshold across its layers: a layer
    of large gradients takes every slot, and entries tied at the threshold
    are all sent (k = 6 here, 9 sent), as in JAX."""
    g = torch.ones(3, 10)
    g[1] = 100.0
    g[1, 0] = 50.0
    sent, resid = P.compress_tree({"w": g}, {"w": torch.zeros(3, 10)},
                                  P.CompressionConfig("topk", 0.2))
    assert torch.equal(sent["w"], torch.where(g == 100.0, g, 0.0))
    assert torch.equal(sent["w"] + resid["w"], g)


def test_none_and_parse():
    g = {"a": torch.ones(3)}
    assert P.compress_tree(g, {"a": torch.zeros(3)},
                           P.CompressionConfig())[0] is g
    for spec in (None, "none", "int8", "topk:0.25"):
        assert P.CompressionConfig.parse(spec) == P.CompressionConfig(
            **vars(J.CompressionConfig.parse(spec)))
    with pytest.raises(ValueError, match="unknown"):
        P.CompressionConfig.parse("fp4")


def _bf16_key(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits as integers in the order of the values, neighbours 1
    apart (+0 and -0 both 0)."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b & 0x7FFF)


def _close(p, j, rtol, what):
    """bfloat16: within one bfloat16 ulp of each element. float32: rtol,
    plus rtol times the leaf's largest magnitude as atol: where
    ``b1 * m + (1 - b1) * g`` cancels, a 1-ulp difference of the clip
    factor is large relative to the result but not to its terms."""
    if p.dtype == torch.bfloat16:
        ulps = np.abs(_bf16_key(_bits(p).view(np.uint16))
                      - _bf16_key(_bits(j).view(np.uint16)))
        assert ulps.max(initial=0) <= 1, (what, int(ulps.max()))
        return
    p32 = p.to(torch.float32).numpy()
    j32 = np.asarray(jnp.asarray(j, jnp.float32))
    np.testing.assert_allclose(p32, j32, rtol=rtol,
                               atol=rtol * float(np.abs(j32).max()),
                               err_msg=what)


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mdtype", ["float32", "bfloat16"])
def test_adamw_update_matches(pdtype, mdtype):
    rng = np.random.default_rng(3)
    cfg = adamw.AdamWConfig(moment_dtype=mdtype, grad_clip=5.0)
    jcfg = j_adamw.AdamWConfig(moment_dtype=mdtype, grad_clip=5.0)
    params = _map(lambda _, s: torch.as_tensor(
        rng.standard_normal(s), dtype=torch.float32).to(pdtype), SHAPES)
    jparams = _map(lambda k, _: _to_jax(dict(_leaves(params))[k]), SHAPES)
    opt, jopt = adamw.init(params, cfg), j_adamw.init(jparams, jcfg)
    for step in range(3):
        g = _grads(rng, pdtype)
        jg = _map(lambda k, _: _to_jax(dict(_leaves(g))[k]), SHAPES)
        params, opt, gn = adamw.update(g, opt, params, cfg)
        jparams, jopt, jgn = j_adamw.update(jg, jopt, jparams, jcfg)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        assert int(opt["step"]) == int(jopt["step"]) == step + 1
        for name, port, ref in (("params", params, jparams),
                                ("m", opt["m"], jopt["m"]),
                                ("v", opt["v"], jopt["v"])):
            for (k, p), (_, j) in zip(_leaves(port), _leaves(ref)):
                assert p.dtype == getattr(torch, str(j.dtype))
                _close(p, j, 1e-6, f"{name}/{k} step {step}")


def test_global_norm_and_clip_match():
    rng = np.random.default_rng(9)
    g = _grads(rng, torch.float32)
    jg = _map(lambda k, _: _to_jax(dict(_leaves(g))[k]), SHAPES)
    np.testing.assert_allclose(float(adamw.global_norm(g)),
                               float(j_adamw.global_norm(jg)), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5), (2, 100)])
def test_cosine_lr_matches(warmup, total):
    steps = np.arange(0, 120, 7, dtype=np.int32)
    got = adamw.cosine_lr(torch.as_tensor(steps), warmup, total, 2.0, 0.1)
    want = j_adamw.cosine_lr(jnp.asarray(steps), warmup, total, 2.0, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
