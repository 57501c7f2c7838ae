"""The port's selective-SSM scan and Mamba heads on the CPU vs the JAX
package's.

The same numpy-seeded inputs go through ``repro.kernels.ssm_scan`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it, and
the oracle ``ssm_chunk_scan_ref``) and through
``repro_torch.kernels.ssm_scan.ops`` on CPU tensors, which take the plain
version: held at the JAX test's rtol = atol = 1e-5 (summation order over
N, the exponential's rounding). The Mamba heads (``models.ssm``) run on
JAX parameters carried across with ``params_from_jax`` and are held at
``tests/test_ssm_chunked.py``'s rtol 2e-4, atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.kernels.ssm_scan import ssm_chunk_scan as j_scan
from repro.kernels.ssm_scan.ref import ssm_chunk_scan_ref
from repro.models import ssm as J_ssm
from repro_torch.configs import ARCHS
from repro_torch.kernels.ssm_scan.ops import ssm_chunk_scan
from repro_torch.kernels.ssm_scan.ref import ssm_chunk_scan_torch
from repro_torch.kernels.ssm_scan.ssm_scan import ssm_chunk_scan_cuda
from repro_torch.models import api, ssm

JAX_SHAPES = [(1, 16, 8, 4, 8), (2, 32, 16, 4, 8), (3, 64, 24, 8, 16),
              (2, 32, 16, 4, 32)]
MODEL_TOL = {"rtol": 2e-4, "atol": 2e-5}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, t, d, n):
    """numpy u, delta, bv, cv, a, s0 as the JAX test draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    delta = np.log1p(np.exp(f(b, t, 1) - 2)).astype(np.float32)
    a = -np.exp(f(d, n) * 0.3).astype(np.float32)
    return f(b, t, d), delta, f(b, t, n), f(b, t, n), a, f(b, d, n)


def _close(got, want, rtol=1e-5, atol=1e-5, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=err_msg)


@pytest.mark.parametrize("b,t,d,n,chunk", JAX_SHAPES)
def test_plain_scan_matches_jax_ref_and_pallas(b, t, d, n, chunk):
    xs = _inputs(b * 100 + t, b, t, d, n)
    y, s = ssm_chunk_scan_torch(*map(torch.from_numpy, xs))
    jy, js = ssm_chunk_scan_ref(*map(jnp.asarray, xs))
    _close(y, jy, err_msg="y vs ref")
    _close(s, js, err_msg="state vs ref")
    py, ps = j_scan(*map(jnp.asarray, xs), chunk=chunk, interpret=True)
    _close(y, py, err_msg="y vs Pallas")
    _close(s, ps, err_msg="state vs Pallas")


@pytest.mark.parametrize("t", [1, 13, 40])
def test_dispatch_takes_any_t_and_updates_s_out_in_place(t):
    """T = 1 and T not a multiple of any chunk (the JAX wrapper runs its
    oracle there); with ``s_out=s0`` the state is updated in place."""
    xs = _inputs(t, 2, t, 24, 16)
    jy, js = ssm_chunk_scan_ref(*map(jnp.asarray, xs))
    u, delta, bv, cv, a, s0 = map(torch.from_numpy, xs)
    y, s = ssm_chunk_scan(u, delta, bv, cv, a, s0)
    _close(y, jy)
    _close(s, js)
    assert not torch.equal(s, s0)
    y2, s2 = ssm_chunk_scan(u, delta, bv, cv, a, s0, s_out=s0)
    assert s2 is s0 and torch.equal(s0, s) and torch.equal(y2, y)


def test_dispatch_takes_strided_views_of_one_projection():
    """delta, bv and cv as slices of one (B, T, 2N + 1) tensor and u as
    half of a (B, T, 2D) one, as ``models.ssm`` passes them."""
    rng = np.random.default_rng(5)
    uz = torch.from_numpy(rng.normal(size=(2, 20, 48)).astype(np.float32))
    bcdt = torch.from_numpy(rng.normal(size=(2, 20, 9)).astype(np.float32))
    a = -torch.exp(torch.from_numpy(rng.normal(size=(24, 4)).astype(
        np.float32)))
    s0 = torch.zeros((2, 24, 4))
    u, delta = uz[..., :24], torch.nn.functional.softplus(bcdt[..., -1:])
    y, s = ssm_chunk_scan(u, delta, bcdt[..., :4], bcdt[..., 4:8], a, s0)
    want = ssm_chunk_scan_ref(*(jnp.asarray(x.contiguous().numpy()) for x in
                                (u, delta, bcdt[..., :4], bcdt[..., 4:8], a,
                                 s0)))
    _close(y, want[0])
    _close(s, want[1])


@pytest.mark.parametrize("bad", ["delta", "bv", "a", "s0", "s_out"])
def test_dispatch_checks_shapes(bad):
    u, delta, bv, cv, a, s0 = map(torch.from_numpy, _inputs(0, 2, 8, 16, 4))
    args = dict(u=u, delta=delta, bv=bv, cv=cv, a=a, s0=s0, s_out=None)
    args[bad] = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="bad shape"):
        ssm_chunk_scan(**args)


def test_launcher_refuses_cpu_tensors():
    xs = list(map(torch.from_numpy, _inputs(0, 1, 4, 8, 4)))
    with pytest.raises(ValueError, match="CUDA device"):
        ssm_chunk_scan_cuda(*xs)
    assert ssm_chunk_scan_cuda.launches == 0


# ---------------------------------------------------------------------------
# Mamba heads on hymba's reduced config
# ---------------------------------------------------------------------------

def _mamba(seed=0, chunk=8):
    jcfg = J_ARCHS["hymba-1.5b"].reduced(chunk_size=chunk, dtype="float32")
    cfg = ARCHS["hymba-1.5b"].reduced(chunk_size=chunk, dtype="float32")
    jp = J_ssm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    p = api.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, p


def _x(cfg, b, t, seed):
    x = np.random.default_rng(seed).normal(size=(b, t, cfg.d_model))
    return x.astype(np.float32)


@pytest.mark.parametrize("t", [1, 8, 12, 32, 48])
def test_mamba_forward_matches_jax(t):
    """The port's kernel path (one scan launch for any T) and its plain
    sequential oracle against JAX's ``mamba_forward`` (chunked where T is
    a multiple of 8, sequential at T = 1 and 12) and
    ``mamba_forward_sequential``."""
    jcfg, cfg, jp, p = _mamba()
    x = _x(cfg, 2, t, t)
    jy, jst = J_ssm.mamba_forward(jp, jnp.asarray(x), jcfg)
    jys, jsts = J_ssm.mamba_forward_sequential(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        y, st = ssm.mamba_forward(p, torch.from_numpy(x), cfg)
        ys, sts = ssm.mamba_forward_sequential(p, torch.from_numpy(x), cfg)
    for got, want, what in ((y, jy, "forward y"), (st["s"], jst["s"],
                                                   "forward state"),
                            (ys, jys, "sequential y"),
                            (sts["s"], jsts["s"], "sequential state")):
        _close(got, want, **MODEL_TOL, err_msg=what)


def test_mamba_forward_carries_state_like_jax():
    """Two halves with the state carried (the JAX test's 48 = 24 + 24)."""
    jcfg, cfg, jp, p = _mamba()
    x = _x(cfg, 2, 48, 2)
    j1, jst = J_ssm.mamba_forward(jp, jnp.asarray(x[:, :24]), jcfg)
    j2, jst2 = J_ssm.mamba_forward(jp, jnp.asarray(x[:, 24:]), jcfg,
                                   state=jst)
    with torch.no_grad():
        y1, st = ssm.mamba_forward(p, torch.from_numpy(x[:, :24]), cfg)
        y2, st2 = ssm.mamba_forward(p, torch.from_numpy(x[:, 24:]), cfg,
                                    state=st)
    _close(torch.cat([y1, y2], 1), jnp.concatenate([j1, j2], 1), **MODEL_TOL)
    _close(st2["s"], jst2["s"], **MODEL_TOL)


def test_mamba_decode_matches_jax_and_writes_the_state_in_place():
    jcfg, cfg, jp, p = _mamba()
    x = _x(cfg, 2, 10, 3)
    jst = J_ssm.mamba_state(jcfg, 2)
    st = ssm.mamba_state(cfg, 2, "cpu")
    s_tensor = st["s"]
    for t in range(10):
        jy, jst = J_ssm.mamba_decode(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                     jcfg)
        with torch.no_grad():
            y, back = ssm.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                       st, cfg)
        assert back is st and st["s"] is s_tensor
        assert y.shape == (2, 1, cfg.d_model)
        _close(y, jy, **MODEL_TOL, err_msg=f"step {t}")
    _close(st["s"], jst["s"], **MODEL_TOL)


def test_mamba_runs_the_scan_through_the_dispatch(monkeypatch):
    """``mamba_forward`` and ``mamba_decode`` each make one call of
    ``ops.ssm_chunk_scan`` (the kernel on a CUDA tensor), the decode with
    T = 1 and the cache's state as both s0 and s_out."""
    _, cfg, _, p = _mamba()
    calls = []
    real = ssm.ssm_chunk_scan

    def counted(u, delta, bv, cv, a, s0, s_out=None):
        calls.append((u.shape[1], s_out is s0))
        return real(u, delta, bv, cv, a, s0, s_out)

    monkeypatch.setattr(ssm, "ssm_chunk_scan", counted)
    x = torch.from_numpy(_x(cfg, 2, 12, 4))
    with torch.no_grad():
        _, st = ssm.mamba_forward(p, x, cfg)
        ssm.mamba_decode(p, x[:, :1], st, cfg)
    assert calls == [(12, False), (1, True)]


def test_init_mamba_matches_jax_tree():
    jcfg, cfg, jp, _ = _mamba()
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg)
    assert sorted(p) == sorted(jp)
    for k, v in p.items():
        assert tuple(v.shape) == jp[k].shape, k
        assert str(v.dtype)[6:] == str(jp[k].dtype), k
    for k in ("a_log", "d_skip", "dt_bias"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
