"""The port's ``launch.steps.make_train_step`` vs the JAX package's, and
the sharded step (``launch.sharded``) on a gloo (2, 2) mesh of 4 CPU ranks
vs the single-process step.

Both run one step from AdamW's zero moments with the step count preset to
2,000, where ``cosine_lr`` is 1 (at step 0 it is 0 and the parameters
would not move), on a batch of 4 x 16 tokens drawn from a seed: qwen3-32b
and deepseek-v2 ``reduced()`` in float32, deepseek-v2 with 8 experts,
top-2, one shared expert and capacity factor 8 (nothing drops, so the EP
lowerings' per-shard capacities change no result).

Every comparison goes through ``launch.sharded.step_gaps``, whose limits
are derived from the changed order of the float32 sums (``step_limit``):
loss, gradient norm, ``m`` and ``v`` relative to their largest value, each
updated parameter elementwise by how far AdamW's direction can move for a
gradient within that limit. Against JAX (XLA sums in its own order) the
same limits hold; so do the loss at rtol 1e-5 and the metrics.

The sharded step keeps the parameters sharded: each layer gathers its
shards inside its body (``parallel.layer_gather``), qwen3-32b's GQA
projections, MLP and vocabulary split over ``model`` (tensor
parallelism), deepseek-v2's MLA and shared expert computed alike on both
``model`` ranks. It runs dense with remat on and off (held to one
process's step and to JAX's), and MoE with each EP lowering inside (the
expert and router leaves left sharded on ``model``). Two planted faults
must exceed the limit: one dp shard's gradient dropped from the
reduce-scatter, and ``model``'s equal copies summed where a rank takes
its own slice. With remat, the most bytes of gathered parameters alive
at once stay within one layer's whole bytes plus the largest leaf outside
the layers. The ranks are one spawn for the module (this file run as
``python tests/test_torch_train_step.py --ranks OUT``).
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import steps as J_steps
from repro.models import api as J_api
from repro.optim import adamw as J_adamw
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.launch import sharded, steps
from repro_torch.models import api, moe
from repro_torch.parallel import layer_gather
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
PRESET = 2_000
B, T_SEQ = 4, 16
MOE_KW = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1,
              capacity_factor=8.0)
CASES = {"dense": ("qwen3-32b", {}), "moe": ("deepseek-v2-236b", MOE_KW),
         "dense-noremat": ("qwen3-32b", {"remat": False})}
# name -> (case, EP lowering, planted fault)
SHARDED = {"dense": ("dense", None, None),
           "dense-noremat": ("dense-noremat", None, None),
           "moe-replicated": ("moe", "replicated", None),
           "moe-a2a": ("moe", "a2a", None),
           "dense-fault": ("dense", None, "dp"),
           "moe-model-fault": ("moe", "replicated", "model")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(case, archs=ARCHS):
    name, kw = CASES[case]
    return archs[name].reduced(dtype="float32", **kw)


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab,
                                             size=(B, T_SEQ + 1))


def _port_state(case):
    cfg = _cfg(case)
    ocfg = adamw.AdamWConfig()
    params = api.init_fn(cfg, "cpu")(0)
    opt = adamw.init(params, ocfg)
    opt["step"] = torch.tensor(PRESET, dtype=torch.int32)
    toks = torch.as_tensor(_tokens(cfg))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    return cfg, ocfg, params, opt, batch


def _lr(ocfg) -> float:
    return ocfg.lr * float(adamw.cosine_lr(torch.tensor(PRESET), 2000,
                                           100_000))


def _flat(tree) -> dict:
    return {p: t.detach() for p, t in T.leaves_with_paths(tree)}


def _single(case) -> dict:
    """One process's ``make_train_step`` and the state around it."""
    cfg, ocfg, params, opt, batch = _port_state(case)
    before = _flat(params)
    before = {k: v.clone() for k, v in before.items()}
    params, opt, out = steps.make_train_step(cfg, ocfg)(params, opt, batch)
    assert int(opt["step"]) == PRESET + 1
    return {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
            "nll": float(out["nll"]), "aux": float(out["aux"]),
            "params": _flat(params), "m": _flat(opt["m"]),
            "v": _flat(opt["v"]), "before": before}


def _gaps(ref, got, case):
    cfg, ocfg = _cfg(case), adamw.AdamWConfig()
    return sharded.step_gaps(ref, got, cfg, ocfg, B * T_SEQ, _lr(ocfg),
                             PRESET + 1)


# -- make_train_step vs JAX ---------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    jcfg, cfg = _cfg(case, J_ARCHS), _cfg(case)
    ocfg, jocfg = adamw.AdamWConfig(), J_adamw.AdamWConfig()
    jparams = J_api.init_fn(jcfg)(jax.random.PRNGKey(0))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    before = {k: v.clone() for k, v in _flat(params).items()}
    jopt = J_adamw.init(jparams, jocfg)
    jopt["step"] = jnp.asarray(PRESET, jnp.int32)
    opt = adamw.init(params, ocfg)
    opt["step"] = torch.tensor(PRESET, dtype=torch.int32)
    toks = _tokens(cfg)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
              "labels": jnp.asarray(toks[:, 1:], jnp.int32)}
    batch = {"tokens": torch.as_tensor(toks[:, :-1].copy()),
             "labels": torch.as_tensor(toks[:, 1:].copy())}
    jp, jo, jout = jax.jit(J_steps.make_train_step(jcfg, jocfg))(
        jparams, jopt, jbatch)
    params, opt, out = steps.make_train_step(cfg, ocfg)(params, opt, batch)
    assert set(out) == set(jout) == {"loss", "grad_norm", "nll", "aux"}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(jout[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    as_t = lambda tree: {k: torch.tensor(np.asarray(v)) for k, v in
                         _flat_jax(tree).items()}
    ref = {"loss": float(jout["loss"]), "grad_norm": float(jout["grad_norm"]),
           "params": as_t(jp), "m": as_t(jo["m"]), "v": as_t(jo["v"]),
           "before": before}
    got = {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]),
           "params": _flat(params), "m": _flat(opt["m"]), "v": _flat(opt["v"])}
    gaps = _gaps(ref, got, case)
    assert max(gaps.values()) <= 1.0, gaps
    moved = max(float((got["params"][k] - before[k]).abs().max())
                for k in before)
    assert moved > 0.5 * _lr(ocfg), moved        # the step moved them
    assert int(opt["step"]) == int(jo["step"]) == PRESET + 1


def _flat_jax(tree) -> dict:
    from repro.parallel.sharding import _path_str
    return {_path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the sharded step on 4 gloo ranks -----------------------------------------

def _rank_body(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh(2, 2)
        shape = api.ShapeSpec("step", T_SEQ, B, "train")
        rules = steps.rules_for(mesh, shape)
        for name, (case, mode, fault) in SHARDED.items():
            cfg, ocfg, params, opt, batch = _port_state(case)
            p, o, b = sharded.shard_state(params, opt, batch, mesh, rules,
                                          shape)
            if name == "moe-a2a":            # the same state, built sharded
                o2 = sharded.init_opt(p, ocfg, PRESET)
                for x, y in zip(T.leaves(o), T.leaves(o2)):
                    assert x.placements == y.placements
                    assert torch.equal(x.to_local(), y.to_local())
                o = o2
            step = sharded.ShardedTrainStep(cfg, ocfg, mesh, rules)
            real = layer_gather.reduce_to_shard
            own = layer_gather.take_own

            def dropped(g, *a, _real=real):
                ax = a[-1]                   # group rank 1 sends no gradient
                return _real(torch.zeros_like(g) if ax.rank == 1 else g,
                             *a)

            def summed(g, *a, _real=real):   # model's copies summed
                return _real(g, *a)
            moe.EP_MODE = mode or "replicated"
            layer_gather.reduce_to_shard = dropped if fault == "dp" else real
            layer_gather.take_own = summed if fault == "model" else own
            try:
                assert step.ep({k: v.to_local() for k, v in b.items()}) \
                    == mode
                p, o, out = step(p, o, b)
            finally:
                layer_gather.reduce_to_shard = real
                layer_gather.take_own = own
                moe.EP_MODE = "replicated"
            res = {f"out|{k}": v.numpy() for k, v in out.items()}
            res["gathered_peak"] = np.asarray(step.plan.gathered["peak"])
            res["roles"] = np.asarray(sorted(
                f"{path}:{step.plan.role(path)}"
                for path, _ in T.leaves_with_paths(p)))
            for tag, tree in (("params", p), ("m", o["m"]), ("v", o["v"])):
                for path, t in T.leaves_with_paths(
                        sharded.gather_tree(tree)):
                    res[f"{tag}|{path}"] = t.numpy()
            for path, d in T.leaves_with_paths(p):   # to one rank only
                whole = sharded.gather_to(d, 0)
                assert (whole is None) == (rank != 0)
                if rank == 0:
                    assert torch.equal(whole, torch.as_tensor(
                        res[f"params|{path}"]))
            res["step"] = o["step"].to_local().numpy()
            np.savez(os.path.join(out_dir, f"{name}-rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _spawn(out_dir):
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(4, os.path.join(tmp, "store"), out_dir),
                 nprocs=4)


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.Popen([sys.executable, __file__, "--ranks", tmp],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-4000:]
        return {name: [dict(np.load(os.path.join(tmp, f"{name}-rank{r}.npz")))
                       for r in range(4)] for name in SHARDED}


def _got(rank_out: dict) -> dict:
    t = lambda tag: {k[len(tag) + 1:]: torch.as_tensor(v)
                     for k, v in rank_out.items() if k.startswith(f"{tag}|")}
    return {"loss": float(rank_out["out|loss"]),
            "grad_norm": float(rank_out["out|grad_norm"]),
            "params": t("params"), "m": t("m"), "v": t("v")}


@pytest.mark.parametrize("name", [n for n in SHARDED if "fault" not in n])
def test_sharded_step_equals_single_process(ranks, name):
    case = SHARDED[name][0]
    ref = _single(case)
    outs = ranks[name]
    for r in range(1, 4):                      # every rank the same result
        for k, v in outs[0].items():
            np.testing.assert_array_equal(outs[r][k], v, err_msg=(k, r))
    assert int(outs[0]["step"]) == PRESET + 1
    gaps = _gaps(ref, _got(outs[0]), case)
    assert max(gaps.values()) <= 1.0, gaps
    np.testing.assert_allclose(float(outs[0]["out|aux"]), ref["aux"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(outs[0]["out|nll"]), ref["nll"],
                               rtol=1e-5)


def test_dropped_dp_shard_exceeds_the_limit(ranks):
    gaps = _gaps(_single("dense"), _got(ranks["dense-fault"][0]), "dense")
    assert gaps["m"] > 10 and gaps["grad_norm"] > 10, gaps
    assert gaps["loss"] <= 1.0, gaps             # the forward is untouched


def test_summing_models_copies_exceeds_the_limit(ranks):
    """The leaves every ``model`` rank computes with alike (MLA's, the
    shared expert's, the norms') take this rank's slice of the gradient;
    summing the copies instead doubles their gradients."""
    gaps = _gaps(_single("moe"), _got(ranks["moe-model-fault"][0]), "moe")
    assert gaps["m"] > 10 and gaps["grad_norm"] > 10, gaps
    assert gaps["loss"] <= 1.0, gaps


def test_roles_split_the_dense_products_over_model(ranks):
    """qwen3-32b reduced (4 heads, 2 KV heads, d_ff 128) on model 2: the
    GQA projections and the MLP tensor-parallel, the vocabulary split,
    the qk norms' gradients summed over model; deepseek-v2's MLA leaves
    gathered whole, its experts kept under EP."""
    roles = dict(r.split(":") for r in ranks["dense"][0]["roles"])
    for leaf in ("w_q", "w_k", "w_v", "w_o"):
        assert roles[f"layers/attn/{leaf}"] == "tp"
    for leaf in ("w_gate", "w_up", "w_down"):
        assert roles[f"layers/mlp/{leaf}"] == "tp"
    assert roles["layers/attn/q_norm"] == roles["layers/attn/k_norm"] \
        == "partial"
    assert roles["embed_tokens"] == roles["lm_head"] == "tp"
    assert roles["layers/ln1/scale"] == roles["final_norm/scale"] == "whole"
    moe_roles = dict(r.split(":") for r in ranks["moe-a2a"][0]["roles"])
    assert moe_roles["layers/attn/w_ukv"] == "whole"
    assert moe_roles["layers/moe/experts/w_up"] == "keep"
    assert moe_roles["prefix/0/mlp/w_up"] == "tp"


def _layer_bytes(params) -> tuple[int, int]:
    """(one layer's whole bytes, the largest leaf outside the layers):
    the stack's bytes over its depth, or a prefix block's, whichever is
    more; the EP-kept expert leaves left out (never gathered)."""
    flat = dict(T.leaves_with_paths(params))
    nb = lambda t: t.numel() * t.element_size()
    stack = sum(nb(t) // t.shape[0] for p, t in flat.items()
                if p.startswith("layers/") and "experts/" not in p)
    prefix = {}
    for p, t in flat.items():
        if p.startswith(("prefix/", "blocks/")):
            key = "/".join(p.split("/")[:2])
            prefix[key] = prefix.get(key, 0) + nb(t)
    rest = max(nb(t) for p, t in flat.items()
               if not p.startswith(("layers/", "prefix/", "blocks/")))
    return max([stack, *prefix.values()]), rest


@pytest.mark.parametrize("name", ["dense", "moe-replicated", "moe-a2a"])
def test_gathered_parameters_alive_at_once_are_one_layer(ranks, name):
    """With remat, the most bytes of gathered parameters alive on a rank
    at once stay within one layer's whole bytes plus the largest leaf
    outside the layers (the head, gathered for the logits, is alive while
    the last layer recomputes)."""
    _, _, params, _, _ = _port_state(SHARDED[name][0])
    layer, rest = _layer_bytes(params)
    for r in range(4):
        peak = int(ranks[name][r]["gathered_peak"])
        assert 0 < peak <= layer + rest, (r, peak, layer, rest)


def test_sharded_step_equals_jax(ranks):
    """The sharded dense step (layer gather, tensor parallelism, the
    vocabulary split) against JAX's own ``make_train_step`` on the same
    parameters and batch, within the same limits."""
    from repro.parallel.sharding import _path_str
    cfg, ocfg, params, opt, batch = _port_state("dense")
    jcfg, jocfg = _cfg("dense", J_ARCHS), J_adamw.AdamWConfig()
    flat = _flat(params)
    shape = J_api.init_fn(jcfg)(jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(shape)
    jparams = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat[_path_str(p)].numpy()) for p, _ in paths])
    jopt = J_adamw.init(jparams, jocfg)
    jopt["step"] = jnp.asarray(PRESET, jnp.int32)
    jbatch = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in batch.items()}
    jp, jo, jout = jax.jit(J_steps.make_train_step(jcfg, jocfg))(
        jparams, jopt, jbatch)
    as_t = lambda tree: {k: torch.tensor(np.asarray(v)) for k, v in
                         _flat_jax(tree).items()}
    ref = {"loss": float(jout["loss"]), "grad_norm": float(jout["grad_norm"]),
           "params": as_t(jp), "m": as_t(jo["m"]), "v": as_t(jo["v"]),
           "before": {k: v.clone() for k, v in flat.items()}}
    for name in ("dense", "dense-noremat"):
        gaps = _gaps(ref, _got(ranks[name][0]), "dense")
        assert max(gaps.values()) <= 1.0, (name, gaps)

def test_sharded_step_refuses_dense_dispatch_over_dp_blocks():
    """A MoE config whose EP conditions fail on a mesh with several dp
    ranks is refused, not run as another dispatch."""
    class Mesh:
        mesh_dim_names = ("data", "model")
        mesh = np.empty((2, 3), dtype=np.int8)

    cfg = _cfg("moe")                            # 8 experts over 3 columns
    step = sharded.ShardedTrainStep.__new__(sharded.ShardedTrainStep)
    step.cfg, step.mesh = cfg, Mesh()
    step.rules = steps.rules_for(Mesh())
    step.dpa = type("A", (), {"size": 2})()
    with pytest.raises(ValueError, match="dense dispatch"):
        step.ep({"tokens": torch.zeros(2, 16, dtype=torch.int64)})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:
        _spawn(sys.argv[2])
    else:
        sys.exit("usage: test_torch_train_step.py --ranks OUT_DIR")
