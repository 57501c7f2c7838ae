"""The port's expert-parallel MoE (``repro_torch.models.moe``'s
``_moe_forward_ep`` and ``_moe_forward_ep_a2a``) on 8 gloo CPU ranks vs
the JAX package's own EP lowerings and vs the port's dense dispatch.

The layer is ``tests/helpers/moe_ep_check.py``'s: deepseek-v2 reduced to
8 experts, top-2, d_ff_expert 32, one shared expert, float32, x of (4, 16,
d). The JAX side runs ``moe.moe_forward`` under ``axis_rules(make_rules(
False), mesh)`` on 8 fake CPU devices, the mesh built directly as
``jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4), ("data",
"model"))``: under jax 0.9 ``jax.make_mesh`` makes Explicit axes, which
the helper's ``with_sharding_constraint`` refuses (ROADMAP C4). It runs in
one subprocess (this file run as ``--jax-ref``). The port's side is 8
ranks on a (2, 4) ``DeviceMesh`` (``--ranks``), each holding its shards:
x's dp block, ``router/w``'s (d / 2, E) rows, its 2 experts with d split
over ``data``, the shared expert whole. Both are started together, once
for the module.

Each mode runs at capacity factor 8.0 (nothing drops) and 1.0 (the shards
drop pairs); the loss is the helper's, sum(y^2) + 0.01 aux. Held, with the
JAX helper's tolerances (forward rtol 2e-5 and atol 2e-5, aux rtol 1e-5;
gradients rtol 5e-4, atol 5e-5): y, aux and the gradients of x and of
every parameter against JAX's EP in both modes and at both factors;
against the port's dense dispatch at 8.0; at 1.0 the dense dispatch
differs from both EP results. The model columns of a dp row hold the same
y and x gradient bit for bit. Without ranks: the selection falls back to
the dense dispatch where G = 1, E % G != 0 or the tokens do not divide.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.models import moe
from repro_torch.parallel import sharding as sh

ROOT = Path(__file__).resolve().parents[1]
N_DEV, DP, G = 8, 2, 4
B, T_SEQ = 4, 16
FACTORS = (8.0, 1.0)
MODES = ("replicated", "a2a")
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=5e-5)
CFG_KW = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
              dtype="float32")


def _cfg(cf, archs=ARCHS):
    return archs["deepseek-v2-236b"].reduced(capacity_factor=cf, **CFG_KW)


def _inputs() -> dict:
    """The JAX layer's initial parameters and x, as numpy."""
    import jax

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import moe as J_moe
    p = J_moe.init_moe(jax.random.PRNGKey(0), _cfg(8.0, J_ARCHS))
    out = {f"p|{k}": np.asarray(v) for k, v in _flat(p).items()}
    x = np.random.default_rng(1).standard_normal(
        (B, T_SEQ, _cfg(8.0).d_model)).astype(np.float32)
    out["x"] = x
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat: dict) -> dict:
    return T.unflatten(flat)


# -- the JAX reference (this file run as a script) ----------------------------

def _jax_reference(fin, fout):
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import moe as J_moe
    from repro.parallel.sharding import axis_rules, make_rules
    assert jax.device_count() == N_DEV, jax.device_count()
    data = dict(np.load(fin))
    p = _unflat({k[2:]: jnp.asarray(v) for k, v in data.items()
                 if k.startswith("p|")})
    x = jnp.asarray(data["x"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(DP, G),
                             ("data", "model"))
    rules = make_rules(multi_pod=False)
    out = {}
    for cf in FACTORS:
        cfg = _cfg(cf, J_ARCHS)

        def loss(p, x, fwd):
            y, aux = fwd(p, x, cfg)
            return jnp.sum(y ** 2) + 0.01 * aux

        dense = J_moe._moe_forward_dense
        runs = {"dense": (dense, None)}
        runs.update({m: (J_moe.moe_forward, m) for m in MODES})
        for name, (fwd, mode) in runs.items():
            J_moe.EP_MODE = mode or "replicated"
            with mesh, axis_rules(rules if mode else None,
                                  mesh if mode else None):
                y, aux = jax.jit(lambda p, x: fwd(p, x, cfg))(p, x)
                gp, gx = jax.jit(jax.grad(lambda p, x: loss(p, x, fwd),
                                          argnums=(0, 1)))(p, x)
            tag = f"{name}|{cf}"
            out[f"{tag}|y"], out[f"{tag}|aux"] = np.asarray(y), np.asarray(aux)
            out[f"{tag}|g|x"] = np.asarray(gx)
            for k, v in _flat(gp).items():
                out[f"{tag}|g|{k}"] = np.asarray(v)
    np.savez(fout, **out)


# -- the port's ranks (this file run as a script) -----------------------------

def _rank_body(rank, world, store, fin, out_dir):
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharded import shard
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(DP, G)
        rules = sh.make_rules(multi_pod=False)
        i, _ = mesh.get_coordinate()
        data = dict(np.load(fin))
        full = _unflat({k[2:]: torch.as_tensor(v) for k, v in data.items()
                        if k.startswith("p|")})
        moe_full = {k: v for k, v in full.items() if k != "shared"}
        placed = shard(moe_full, mesh, steps.param_pspecs(moe_full, rules))
        res = {}
        for cf in FACTORS:
            cfg = _cfg(cf)
            for mode in MODES:
                p = T.tree_map(lambda d: d.to_local().clone().requires_grad_(),
                               placed)
                p["shared"] = T.tree_map(
                    lambda t: t.clone().requires_grad_(), full["shared"])
                x = torch.as_tensor(data["x"]).chunk(DP)[i].clone()
                x.requires_grad_()
                moe.EP_MODE = mode
                bins = []
                real = moe._sort_into_bins

                def logged(ids, n_bins, cap, _real=real, _bins=bins):
                    _bins.append([n_bins, cap])
                    return _real(ids, n_bins, cap)
                moe._sort_into_bins = logged
                with sh.axis_rules(rules, mesh):
                    assert moe.ep_mode(x.shape[0] * x.shape[1], cfg) == mode
                    y, aux = moe.moe_forward(p, x, cfg)
                    loss = torch.sum(y ** 2) + 0.01 * aux
                    leaves = dict(T.leaves_with_paths(p))
                    grads = torch.autograd.grad(loss, [x, *leaves.values()])
                moe._sort_into_bins = real
                tag = f"{mode}|{cf}"
                res[f"{tag}|bins"] = np.asarray(bins)
                res[f"{tag}|y"] = y.detach().numpy()
                res[f"{tag}|aux"] = aux.detach().numpy()
                res[f"{tag}|g|x"] = grads[0].numpy()
                for k, g in zip(leaves, grads[1:]):
                    res[f"{tag}|g|{k}"] = g.numpy()
        moe.EP_MODE = "replicated"
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _spawn(fin, out_dir):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(N_DEV, os.path.join(tmp, "store"), fin,
                                   out_dir), nprocs=N_DEV)


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        fin = os.path.join(tmp, "in.npz")
        np.savez(fin, **inputs)
        jout = os.path.join(tmp, "jax.npz")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{N_DEV}")
        jax_p = subprocess.Popen(
            [sys.executable, __file__, "--jax-ref", fin, jout],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        ranks = subprocess.Popen(
            [sys.executable, __file__, "--ranks", fin, tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        _, err = ranks.communicate(timeout=240)
        assert ranks.returncode == 0, err[-4000:]
        _, jerr = jax_p.communicate(timeout=240)
        assert jax_p.returncode == 0, jerr[-4000:]
        got = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(N_DEV)]
        want = dict(np.load(jout))
    return inputs, got, want


def _rank(i, j):
    return i * G + j


def _assemble(got, tag) -> dict:
    """The ranks' pieces as whole arrays: y and x's gradient from each dp
    row's first column, the router's rows and the experts' blocks from
    their shards, the shared expert's gradient summed over the dp rows."""
    out = {"y": np.concatenate([got[_rank(i, 0)][f"{tag}|y"]
                                for i in range(DP)]),
           "aux": got[0][f"{tag}|aux"],
           "g|x": np.concatenate([got[_rank(i, 0)][f"{tag}|g|x"]
                                  for i in range(DP)])}
    keys = [k[len(tag) + 3:] for k in got[0] if k.startswith(f"{tag}|g|")
            and k != f"{tag}|g|x"]
    assert len(keys) == 7, keys
    for k in keys:
        piece = lambda i, j: got[_rank(i, j)][f"{tag}|g|{k}"]
        if k == "router/w":
            full = np.concatenate([piece(i, 0) for i in range(DP)])
        elif k.startswith("experts/"):
            dim = 2 if k.endswith("w_down") else 1
            full = np.concatenate([np.concatenate(
                [piece(i, j) for i in range(DP)], axis=dim)
                for j in range(G)])
        else:
            full = sum(piece(i, 0) for i in range(DP))
        out[f"g|{k}"] = full
    return out


def _jax_of(want, tag) -> dict:
    return {k[len(tag) + 1:]: v for k, v in want.items()
            if k.startswith(f"{tag}|")}


def _held(got: dict, ref: dict, what):
    assert sorted(got) == sorted(ref), (what, sorted(got), sorted(ref))
    np.testing.assert_allclose(got["y"], ref["y"], err_msg=what, **FWD)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-5,
                               err_msg=what)
    for k in got:
        if k.startswith("g|"):
            np.testing.assert_allclose(got[k], ref[k], err_msg=f"{what} {k}",
                                       **GRAD)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("mode", MODES)
def test_ep_equals_jax_ep(runs, mode, cf):
    _, got, want = runs
    tag = f"{mode}|{cf}"
    _held(_assemble(got, tag), _jax_of(want, tag), tag)


@pytest.mark.parametrize("mode", MODES)
def test_ep_equals_dense_dispatch_where_nothing_drops(runs, mode):
    """At capacity factor 8 the port's EP equals the port's dense
    dispatch (and JAX's)."""
    inputs, got, want = runs
    cfg = _cfg(8.0)
    p = _unflat({k[2:]: torch.tensor(v).requires_grad_()
                 for k, v in inputs.items() if k.startswith("p|")})
    x = torch.as_tensor(inputs["x"]).requires_grad_()
    y, aux = moe._moe_forward_dense(p, x, cfg)
    leaves = dict(T.leaves_with_paths(p))
    grads = torch.autograd.grad(torch.sum(y ** 2) + 0.01 * aux,
                                [x, *leaves.values()])
    dense = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
             "g|x": grads[0].numpy(),
             **{f"g|{k}": g.numpy() for k, g in zip(leaves, grads[1:])}}
    _held(_assemble(got, f"{mode}|8.0"), dense, f"{mode} vs dense")
    _held(_jax_of(want, "dense|8.0"), dense, "JAX dense vs port dense")


def test_low_capacity_shards_drop_where_dense_differs(runs):
    _, got, want = runs
    dense = want["dense|1.0|y"]
    for mode in MODES:
        ep = _assemble(got, f"{mode}|1.0")["y"]
        np.testing.assert_allclose(ep, want[f"{mode}|1.0|y"], **FWD)
        assert np.abs(ep - dense).max() > 1e-2, mode
        assert np.abs(ep - _assemble(got, f"{mode}|8.0")["y"]).max() > 1e-2


@pytest.mark.parametrize("mode", MODES)
def test_model_columns_agree_bit_for_bit(runs, mode):
    _, got, _ = runs
    for cf in FACTORS:
        tag = f"{mode}|{cf}"
        for i in range(DP):
            for j in range(1, G):
                for k in ("y", "g|x", "aux"):
                    np.testing.assert_array_equal(
                        got[_rank(i, j)][f"{tag}|{k}"],
                        got[_rank(i, 0)][f"{tag}|{k}"], err_msg=f"{tag} {k}")


class StandInMesh:
    """A mesh's axis names and sizes: what the selection reads."""

    def __init__(self, shape, names=("data", "model")):
        self.mesh_dim_names = names
        self.mesh = np.empty(shape, dtype=np.int8)


@pytest.mark.parametrize("mode", MODES)
def test_selection_falls_back_to_dense(mode, monkeypatch):
    """G = 1, E % G != 0, or (a2a) tokens that do not split over the
    model axis take the dense dispatch, on what the rank holds, which
    equals ``_moe_forward_dense`` bit for bit; the rules' batch axes must
    cover the non-model ranks."""
    monkeypatch.setattr(moe, "EP_MODE", mode)
    cfg = _cfg(1.25)
    rules = sh.make_rules(multi_pod=False)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg)
    x = torch.randn(1, 6, cfg.d_model, generator=gen)
    assert moe.ep_mode(64, cfg, StandInMesh((2, 4)), rules) == mode
    cases = [StandInMesh((8, 1)), StandInMesh((2, 3))]
    if mode == "a2a":
        cases.append(StandInMesh((2, 4)))       # 6 tokens over 4 columns
    for m in cases:
        assert moe.ep_mode(6, cfg, m, rules) is None, m.mesh.shape
        with sh.axis_rules(rules, m):
            y, aux = moe.moe_forward(p, x, cfg)
        y0, aux0 = moe._moe_forward_dense(p, x, cfg)
        assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert moe.ep_mode(64, cfg, StandInMesh((2, 4)), None) is None
    bad = sh.make_rules(multi_pod=False)
    bad["batch"] = None
    with pytest.raises(ValueError, match="batch axes"):
        moe.ep_mode(64, cfg, StandInMesh((2, 4)), bad)


def test_ep_capacities_are_jax_s(runs):
    """The bins each EP path sorts into, (bins, capacity) per call, are
    JAX's expressions on JAX's N = 64: replicated c_exp = ceil(N_loc k cf
    / E) with N_loc = N // dp_size; a2a c_send = ceil(N_loc k cf / G) and
    c_exp = ceil(G c_send cf / E_loc) with N_loc = N // n_dev."""
    import math
    _, got, _ = runs
    n, k, e = B * T_SEQ, 2, 8
    for cf in FACTORS:
        c_exp = max(1, math.ceil(n // DP * k * cf / e))
        c_send = max(1, math.ceil(n // N_DEV * k * cf / G))
        c_exp2 = max(1, math.ceil(G * c_send * cf / (e // G)))
        for r in range(N_DEV):
            assert got[r][f"replicated|{cf}|bins"].tolist() == [[e // G,
                                                                 c_exp]]
            assert got[r][f"a2a|{cf}|bins"].tolist() == [
                [G, c_send], [e // G, c_exp2]]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-ref"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ranks"]:
        _spawn(sys.argv[2], sys.argv[3])
    else:
        sys.exit("usage: test_torch_moe_ep.py --jax-ref IN OUT | --ranks IN "
                 "OUT_DIR")
