"""The port's sharding (``repro_torch.parallel.sharding`` and the spec
functions of ``repro_torch.launch.steps``) vs the JAX package's.

* ``param_pspecs``, ``opt_pspecs``, ``batch_pspecs`` and ``cache_pspecs``
  equal JAX's ``PartitionSpec``s entry for entry, leaf by leaf, for every
  config of the zoo, the four assigned shapes and both production meshes,
  (16, 16) and (2, 16, 16). Neither side needs the mesh's devices: the spec
  functions read a mesh's axis names and sizes, which a stand-in object
  gives both (JAX's ``axis_names``/``devices.shape``, the port's
  ``mesh_dim_names``/``mesh.shape``); JAX's trees come from
  ``jax.eval_shape``, the port's from the meta device.
* ``abstract_state``, ``abstract_batch`` and ``abstract_caches`` have
  ``jax.eval_shape``'s shapes and dtypes (token ids int64 in the port,
  int32 in JAX: the port's data pipeline makes int64).
* ``rules_for``'s batch-1 case, ``cs`` and ``logical_spec`` without rules,
  and ``axis_rules`` nesting.
* ``named`` on a (2, 2) gloo mesh of 4 CPU ranks (this file run as
  ``python tests/test_torch_sharding.py --ranks IN OUT``): each rank's
  local shard of every leaf of two reduced configs equals the slice that
  JAX's ``NamedSharding`` puts on the device of the same coordinate
  (``devices_indices_map`` on 4 fake CPU devices, this file run as
  ``--jax-ref``). The ranks and the JAX process are one spawn each for
  the module, started together.
"""
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as J_steps
from repro.models import api as J_api
from repro.parallel import sharding as J_sh
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NAMED_CFGS = ("qwen3-32b", "deepseek-v2-236b")


class StandInMesh:
    """A mesh's axis names and sizes, as the JAX and the port's spec
    functions read them; no devices."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.devices = self.mesh = np.empty(shape, dtype=np.int8)


def _jax_flat(tree) -> dict:
    """path -> leaf of a JAX tree, paths as the port joins them."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {J_sh._path_str(p): v for p, v in flat}


def _port_flat(tree) -> dict:
    out = {}
    sh.map_with_path(lambda p, v: out.__setitem__(p, v), tree)
    return out


@functools.lru_cache(maxsize=None)
def _jax_state(name):
    cfg = J_ARCHS[name]
    params = jax.eval_shape(J_api.init_fn(cfg), jax.random.PRNGKey(0))
    return params


@functools.lru_cache(maxsize=None)
def _port_state(name):
    return steps.abstract_state(ARCHS[name])


def _specs_equal(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), (what, path, got[path], spec)
        assert isinstance(got[path], sh.PartitionSpec), (what, path)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(J_api.SHAPES))
@pytest.mark.parametrize("name", list(J_ARCHS))
def test_specs_equal_jax_for_every_config_shape_and_mesh(name, shape, mesh):
    m = StandInMesh(*MESHES[mesh])
    jshape, pshape = J_api.SHAPES[shape], api.SHAPES[shape]
    jrules, rules = J_steps.rules_for(m, jshape), steps.rules_for(m, pshape)
    assert dict(rules) == dict(jrules)
    jspec = J_steps.param_pspecs(_jax_state(name), jrules)
    pspec = steps.param_pspecs(_port_state(name), rules)
    _specs_equal(_port_flat(pspec), _jax_flat(jspec), "params")
    _specs_equal(_port_flat(steps.opt_pspecs(pspec)),
                 _jax_flat(J_steps.opt_pspecs(jspec)), "opt")
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    jb = J_steps.abstract_batch(jcfg, jshape)
    _specs_equal(_port_flat(steps.batch_pspecs(
        steps.abstract_batch(cfg, pshape), m, pshape)),
        _jax_flat(J_steps.batch_pspecs(jb, m, jshape)), "batch")
    jc = J_steps.abstract_caches(jcfg, jshape)
    _specs_equal(_port_flat(steps.cache_pspecs(
        steps.abstract_caches(cfg, pshape), m, pshape)),
        _jax_flat(J_steps.cache_pspecs(jc, m, jshape)), "caches")


def _shapes(flat: dict) -> dict:
    ints = {"int32": "int64"}
    return {p: (tuple(v.shape), ints.get(str(v.dtype).replace("torch.", ""),
                                         str(v.dtype).replace("torch.", "")))
            for p, v in flat.items()}


@pytest.mark.parametrize("name", list(J_ARCHS))
def test_abstract_trees_have_eval_shapes(name):
    from repro.optim import adamw as J_adamw
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    params, opt = steps.abstract_state(cfg, adamw.AdamWConfig())
    assert all(t.device.type == "meta" for t in T.leaves((params, opt)))
    jparams, jopt = J_steps.abstract_state(jcfg, J_adamw.AdamWConfig())
    assert _shapes(_port_flat(params)) == _shapes(_jax_flat(jparams))
    assert _shapes(_port_flat(opt)) == _shapes(_jax_flat(jopt))
    for shape in ("train_4k", "prefill_32k"):
        got = steps.abstract_batch(cfg, api.SHAPES[shape])
        want = J_steps.abstract_batch(jcfg, J_api.SHAPES[shape])
        assert _shapes(_port_flat(got)) == _shapes(_jax_flat(want))
    got = steps.abstract_caches(cfg, api.SHAPES["decode_32k"])
    want = J_steps.abstract_caches(jcfg, J_api.SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for t in T.leaves(got))
    assert _shapes(_port_flat(got)) == _shapes(_jax_flat(want))


def test_rules_for_batch_one_replicates_the_batch():
    m = StandInMesh(*MESHES["16x16"])
    got = steps.rules_for(m, api.SHAPES["long_500k"])
    want = J_steps.rules_for(m, J_api.SHAPES["long_500k"])
    assert dict(got) == dict(want)
    assert got["batch"] is None and got["tokens_flat"] == ("model",)
    assert got["kv_heads"] is None
    m3 = StandInMesh(*MESHES["2x16x16"])
    assert steps.rules_for(m3)["batch"] == ("pod", "data")
    assert dict(steps.rules_for(m3, seq_shard=True)) == dict(
        J_steps.rules_for(m3, seq_shard=True))


def test_partition_spec_normalises_as_jax():
    for entries in [(("data",), None, "model"), ((), None), (None,),
                    (("pod", "data"),), ()]:
        assert tuple(sh.PartitionSpec(*entries)) == tuple(
            jax.sharding.PartitionSpec(*entries))


def test_cs_and_logical_spec_without_rules_are_identities():
    x = torch.randn(3, 4)
    assert sh.current_rules() is None and sh.current_mesh() is None
    assert sh.cs(x, "batch", None) is x
    assert sh.logical_spec("batch", "heads") == sh.PartitionSpec()
    rules = sh.make_rules(multi_pod=False)
    with sh.axis_rules(rules):           # rules but no mesh: a no-op
        assert sh.cs(x, "batch", None) is x
        assert tuple(sh.logical_spec("batch", None, "heads")) == (
            "data", None, "model")


def test_axis_rules_nest_and_restore():
    r1, r2 = sh.make_rules(False), sh.make_rules(True)
    m1, m2 = object(), object()
    with sh.axis_rules(r1, m1):
        assert sh.current_rules() is r1 and sh.current_mesh() is m1
        with sh.axis_rules(r2, m2):
            assert sh.current_rules() is r2 and sh.current_mesh() is m2
            with sh.axis_rules(None):
                assert sh.current_rules() is None
                assert sh.current_mesh() is None
            assert sh.current_rules() is r2
        assert sh.current_rules() is r1 and sh.current_mesh() is m1
        with pytest.raises(RuntimeError):
            with sh.axis_rules(r2, m2):
                raise RuntimeError("inside")
        assert sh.current_rules() is r1 and sh.current_mesh() is m1
    assert sh.current_rules() is None and sh.current_mesh() is None


def test_remat_recompute_sees_the_forward_rules_on_another_thread():
    """The backward of CUDA tensors runs on autograd's threads; a remat
    block recomputed there must see the rules and mesh of its forward
    (``checkpoint_context``), or a MoE layer would take another path."""
    import threading

    from torch.utils.checkpoint import checkpoint
    seen = []

    def block(x):
        seen.append((sh.current_rules(), sh.current_mesh()))
        return torch.sin(x) * 2

    rules, mesh = sh.make_rules(False), object()
    x = torch.randn(5, requires_grad=True)
    with sh.axis_rules(rules, mesh):
        y = checkpoint(block, x, use_reentrant=False,
                       context_fn=sh.checkpoint_context)
    out = []
    t = threading.Thread(target=lambda: out.append(
        torch.autograd.grad(y.sum(), x)[0]))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and len(out) == 1
    assert len(seen) == 2 and seen[1] == (rules, mesh), seen
    torch.testing.assert_close(out[0], 2 * torch.cos(x.detach()))
    assert sh.current_rules() is None


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = StandInMesh(*MESHES["2x16x16"])
    got = sh.placements(m, sh.PartitionSpec(("pod", "data"), "model"), 2)
    assert got == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(m, sh.PartitionSpec(None, "data"), 2) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        sh.placements(m, sh.PartitionSpec(("data", "pod")), 1)
    with pytest.raises(ValueError, match="names axis"):
        sh.placements(m, sh.PartitionSpec("expert"), 1)


# -- named on a gloo (2, 2) mesh ---------------------------------------------

def _named_leaves():
    """(config, path) -> a float32 numpy array: two reduced configs'
    parameters (widths that split over 2 x 2)."""
    out = {}
    for name in NAMED_CFGS:
        cfg = ARCHS[name].reduced(dtype="float32")
        params = api.init_fn(cfg, "cpu")(0)
        for path, t in T.leaves_with_paths(params):
            out[f"{name}|{path}"] = t.detach().numpy()
    return out


def _rank_body(rank, world, store, fin, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.sharded import shard
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(2, 2)
        rules = steps.rules_for(mesh)
        data = dict(np.load(fin))
        res = {}
        for name in NAMED_CFGS:
            keys = [k for k in data if k.startswith(f"{name}|")]
            tree = T.unflatten({k.split("|", 1)[1]: torch.as_tensor(data[k])
                                for k in keys})
            specs = steps.param_pspecs(tree, rules)
            placed = shard(tree, mesh, specs)
            for path, d in T.leaves_with_paths(placed):
                res[f"{name}|{path}"] = d.to_local().numpy()
                assert tuple(d.shape) == tuple(data[f"{name}|{path}"].shape)
        # cs on a DTensor: redistributed to the logical spec, same values
        from torch.distributed.tensor import Replicate, Shard
        x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
        d = shard(x, mesh, sh.PartitionSpec())
        with sh.axis_rules(rules, mesh):
            y = sh.cs(d, "batch", "heads")
            z = sh.cs(y, None, None)
            same = sh.cs(z, None, None)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert tuple(z.placements) == (Replicate(), Replicate())
        assert same is z
        res["cs|local"] = y.to_local().numpy()
        res["cs|full"] = z.to_local().numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _jax_reference(fin, fout):
    """Each leaf's slice on each of the 4 devices of a (2, 2) mesh under
    its JAX spec, as ``NamedSharding`` places it."""
    from jax.sharding import Mesh, NamedSharding
    assert jax.device_count() == 4, jax.device_count()
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = J_steps.rules_for(mesh)
    data = dict(np.load(fin))
    out = {}
    for name in NAMED_CFGS:
        keys = [k for k in data if k.startswith(f"{name}|")]
        flat = {k.split("|", 1)[1]: data[k] for k in keys}
        for path, arr in flat.items():
            spec = J_sh._spec_for_path(
                path, rules, any(f"/{sp}/" in f"/{path}/" for sp in
                                 ("layers", "enc_layers", "dec_layers")))
            spec = jax.sharding.PartitionSpec(*list(spec)[:arr.ndim])
            idx = NamedSharding(mesh, spec).devices_indices_map(arr.shape)
            for i, dev in enumerate(mesh.devices.flat):
                out[f"{name}|{path}|{i}"] = arr[idx[dev]]
    np.savez(fout, **out)


@pytest.fixture(scope="module")
def named_runs():
    leaves = _named_leaves()
    with tempfile.TemporaryDirectory() as tmp:
        fin = os.path.join(tmp, "in.npz")
        np.savez(fin, **leaves)
        jout = os.path.join(tmp, "jax.npz")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
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
               for r in range(4)]
        want = dict(np.load(jout))
    return leaves, got, want


@pytest.mark.parametrize("name", NAMED_CFGS)
def test_named_local_shards_equal_jax_named_sharding(named_runs, name):
    leaves, got, want = named_runs
    keys = [k for k in leaves if k.startswith(f"{name}|")]
    assert keys
    sharded = 0
    for key in keys:
        for r in range(4):
            np.testing.assert_array_equal(got[r][key], want[f"{key}|{r}"],
                                          err_msg=f"{key} rank {r}")
        sharded += got[0][key].shape != leaves[key].shape
    assert sharded >= 5, sharded         # the test splits real leaves


def test_cs_redistributes_a_dtensor_under_rules(named_runs):
    """On the (2, 2) mesh, ``cs(d, "batch", "heads")`` puts rank (i, j)
    the (i, j) block of a replicated DTensor, and ``cs(., None, None)``
    replicates it again, unchanged."""
    _, got, _ = named_runs
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for r in range(4):
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(got[r]["cs|local"],
                                      x[2 * i:2 * i + 2, 3 * j:3 * j + 3])
        np.testing.assert_array_equal(got[r]["cs|full"], x)


def test_named_maps_specs_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    m = StandInMesh(*MESHES["16x16"])
    tree = {"a": sh.PartitionSpec("data", None), "b": [sh.PartitionSpec()],
            "c": sh.PartitionSpec(None, ("data", "model"))}
    got = steps.named(m, tree)
    assert got == {"a": (Shard(0), Replicate()),
                   "b": [(Replicate(), Replicate())],
                   "c": (Shard(1), Shard(1))}


def _spawn(fin, out_dir):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(4, os.path.join(tmp, "store"), fin,
                                   out_dir), nprocs=4)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-ref"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ranks"]:
        _spawn(sys.argv[2], sys.argv[3])
    else:
        sys.exit("usage: test_torch_sharding.py --jax-ref IN OUT | --ranks "
                 "IN OUT_DIR")
