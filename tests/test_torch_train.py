"""The port's trainer on the CPU vs the JAX package's.

* ``SyntheticLM`` batches are the JAX package's bit for bit;
* checkpoints written by either package restore bit for bit in the other;
* the post-gradient half of a step (per-worker compression with error
  feedback -> SOAR reduce -> scale -> AdamW) on identical per-worker
  gradients, against the JAX ``compress_tree``, ``reduce_local`` inside a
  shard_map over 8 fake CPU devices, and ``adamw.update``: bit for bit up
  to AdamW and within the AdamW tolerance of ``test_torch_optim.py`` after
  it. Each AdamW step is also held against the JAX ``adamw.update`` on
  the port's own inputs: bfloat16 parameters bit for bit, float32 ones to
  rtol 1e-6; a planted fault (parameters never written) must fail that
  check. The JAX side of the chain runs in one subprocess (this file run as ``python
  tests/test_torch_train.py --jax-ref IN OUT``; the device count must be
  set before JAX starts);
* a whole step with 1 worker (the JAX ``make_step``) and with 8 (each
  worker's ``jax.value_and_grad`` on its shard, then the same reduce and
  AdamW), float32, no compression: loss and gradient norm within the model
  tolerance of ``test_torch_model.py``, the parameters after AdamW within
  rtol 1e-4 and atol 3e-5 (a tenth of the learning rate: where a
  gradient's two steps cancel in the first moment, a 1e-4 relative
  difference of the gradient moves ``m / sqrt(v)`` by a few percent).
  Top-k is compared on identical gradients only: a 1-ulp difference of a
  gradient can move an entry across the threshold.
  The JAX ``make_step`` itself is not the reference at 8 workers: under
  the installed JAX its shard_map sums the parameter gradients over the
  devices before compressing them (ROADMAP C8);
* ``grad_scale / n_dev`` is rounded to the gradients' dtype before it
  multiplies, as JAX does with a weakly typed scalar;
* the program the port's ``main`` runs is the JAX ``Orchestrator``'s;
* ``main`` runs, checkpoints and resumes bit for bit;
* ``main --fail`` replans through the port's ``Orchestrator``: the program
  and ``grad_scale`` it installs equal the JAX ``Orchestrator``'s after the
  same failure, its losses equal a run built directly from those programs
  with the dead workers' batch shards zeroed (bit for bit), a dead
  worker's sent row is not read by the reduce, and a resumed run replays
  the failures before its first step.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.collectives import build_program as j_build_program
from repro.configs import ARCHS as J_ARCHS
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import train as J_train
from repro.models import api as J_api
from repro.optim import adamw as j_adamw
from repro.runtime import Orchestrator, OrchestratorConfig
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.optim.compression import (CompressionConfig, compress_leaf,
                                           init_error_feedback)
from test_torch_collectives import _same_program

ROOT = Path(__file__).resolve().parents[1]
N_DEV = 8
LEAVES = {"embed": (40, 12), "layers_w": (3, 12, 8), "scale": (12,)}
# (dtype, grad_scale, codec) of the post-gradient cases; 8/7 is not dyadic
CASES = [("float32", 1.0, "topk:0.1"), ("bfloat16", 1.0, "topk:0.1"),
         ("bfloat16", 8 / 7, "topk:0.1"), ("float32", 1.0, "int8")]
STEP_CFG = dict(dtype="float32")          # reduced configs, whole steps
PARAM_ATOL = 0.1 * adamw.AdamWConfig().lr  # params after AdamW (docstring)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).numpy().view(jnp.bfloat16)
    return t.detach().numpy()


def _bitwise(t: torch.Tensor, a: np.ndarray, what: str):
    got = _to_np(t)
    assert got.dtype == a.dtype and got.shape == a.shape, what
    assert np.array_equal(_np_bits(got).reshape(-1).view(np.uint8),
                          _np_bits(a).reshape(-1).view(np.uint8)), what


def _inputs():
    """Per-case initial params and two steps of per-worker gradients."""
    rng = np.random.default_rng(21)
    arrays = {}
    for c, (dt, _, _) in enumerate(CASES):
        jdt = jnp.dtype(dt)
        for leaf, shape in LEAVES.items():
            arrays[f"{c}/p/{leaf}"] = np.asarray(jnp.asarray(
                rng.standard_normal(shape), jdt))
            for s in range(2):
                g = rng.standard_normal((N_DEV,) + shape) * 10.0 ** \
                    rng.integers(-3, 1, (N_DEV,) + shape)
                arrays[f"{c}/g{s}/{leaf}"] = np.asarray(jnp.asarray(g, jdt))
    cfg = ARCHS["qwen3-32b"].reduced(**STEP_CFG)
    b = SyntheticLM(cfg, DataConfig(N_DEV, 16), device="cpu").batch(0)
    arrays["tokens"] = b["tokens"].numpy().astype(np.int32)
    arrays["labels"] = b["labels"].numpy().astype(np.int32)
    return arrays


def _store(arrays: dict) -> dict:
    """bfloat16 arrays as uint16 bits under ``<key>::bf16`` (npz keeps no
    bfloat16)."""
    return {(k + "::bf16" if v.dtype.name == "bfloat16" else k):
            (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
            for k, v in arrays.items()}


def _load(path) -> dict:
    data = np.load(path)
    return {(k[:-6] if k.endswith("::bf16") else k):
            (data[k].view(jnp.bfloat16) if k.endswith("::bf16") else data[k])
            for k in data.files}


def _jax_reference(path_in: str, path_out: str) -> None:
    """Subprocess body: the JAX side on 8 fake CPU devices."""
    from jax.sharding import PartitionSpec as P

    from repro.collectives.tree_allreduce import _shard_map, reduce_local
    from repro.optim import compression as jc
    assert jax.device_count() == N_DEV, jax.device_count()
    data = _load(path_in)
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    prog = Orchestrator(J_train.dp_fleet(N_DEV),
                        OrchestratorConfig(k=2, strategy="soar")).program

    def reducer(scale):
        # make_step's shard_map body, after compression
        body = lambda s: jax.tree.map(
            lambda g: reduce_local(g[0], prog, "data") * scale, s)
        return jax.jit(_shard_map(body, mesh=mesh, in_specs=(P("data"),),
                                  out_specs=P()))

    out = {}
    ocfg = j_adamw.AdamWConfig()
    for c, (_, grad_scale, spec) in enumerate(CASES):
        ccfg = jc.CompressionConfig.parse(spec)
        params = {k: jnp.asarray(data[f"{c}/p/{k}"]) for k in LEAVES}
        opt = j_adamw.init(params, ocfg)
        ef = [{k: jnp.zeros(s, jnp.float32) for k, s in LEAVES.items()}
              for _ in range(N_DEV)]
        run = reducer(grad_scale / N_DEV)
        for s in range(2):
            sent = []
            for i in range(N_DEV):
                g = {k: jnp.asarray(data[f"{c}/g{s}/{k}"][i]) for k in LEAVES}
                si, ef[i] = jc.compress_tree(g, ef[i], ccfg)
                sent.append(si)
            stacked = {k: jnp.stack([si[k] for si in sent]) for k in LEAVES}
            grads = run(stacked)
            params, opt, gn = j_adamw.update(grads, opt, params, ocfg)
            for k in LEAVES:
                out[f"{c}/{s}/sent/{k}"] = np.asarray(stacked[k])
                out[f"{c}/{s}/ef/{k}"] = np.stack(
                    [np.asarray(e[k]) for e in ef])
                out[f"{c}/{s}/grad/{k}"] = np.asarray(grads[k])
                out[f"{c}/{s}/p/{k}"] = np.asarray(params[k])
                out[f"{c}/{s}/m/{k}"] = np.asarray(opt["m"][k])
                out[f"{c}/{s}/v/{k}"] = np.asarray(opt["v"][k])
            out[f"{c}/{s}/gnorm"] = np.asarray(gn)
    # a whole step with 8 workers, no compression: each worker's gradient
    # on its shard, then the reduce and AdamW
    cfg = J_ARCHS["qwen3-32b"].reduced(**STEP_CFG)
    params = J_api.init_fn(cfg)(jax.random.PRNGKey(0))
    for k, v in T.leaves_with_paths(jax.tree.map(np.asarray, params)):
        out[f"step/init/{k}"] = v
    vg = jax.jit(jax.value_and_grad(J_api.loss_fn(cfg), has_aux=True))
    per = data["tokens"].shape[0] // N_DEV
    losses, grads = [], []
    for i in range(N_DEV):
        shard = {k: jnp.asarray(data[k][i * per:(i + 1) * per])
                 for k in ("tokens", "labels")}
        (loss, _), g = vg(params, shard)
        losses.append(loss)
        grads.append(g)
    stacked = jax.tree.map(lambda *g: jnp.stack(g), *grads)
    reduced = reducer(1.0 / N_DEV)(stacked)
    params, _, gn = j_adamw.update(reduced, j_adamw.init(params, ocfg),
                                   params, ocfg)
    out["step/loss"] = np.asarray(jnp.mean(jnp.stack(losses)))
    out["step/gnorm"] = np.asarray(gn)
    for k, v in T.leaves_with_paths(jax.tree.map(np.asarray, params)):
        out[f"step/p/{k}"] = v
    np.savez(path_out, **_store(out))


@pytest.fixture(scope="module")
def jax_ref():
    arrays = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(fin, **_store(arrays))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={N_DEV}")
        res = subprocess.run(
            [sys.executable, __file__, "--jax-ref", fin, fout],
            capture_output=True, text=True, env=env, timeout=240)
        assert res.returncode == 0, res.stderr[-4000:]
        return arrays, _load(fout)


def _close(t: torch.Tensor, a: np.ndarray, rtol: float, what: str):
    got = t.detach().to(torch.float32).numpy()
    want = np.asarray(a, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _jax_adamw(grads, opt, params):
    """The JAX ``adamw.update`` on copies of the port's state."""
    j = lambda t: jnp.array(_to_np(t), copy=True)
    jopt = {"m": {k: j(v) for k, v in opt["m"].items()},
            "v": {k: j(v) for k, v in opt["v"].items()},
            "step": j(opt["step"])}
    return j_adamw.update({k: j(v) for k, v in grads.items()}, jopt,
                          {k: j(v) for k, v in params.items()},
                          j_adamw.AdamWConfig())


def _assert_adamw_step(params, opt, want_p, want_opt, dt, s):
    """The port's AdamW against JAX's on the same inputs: bfloat16
    parameters bit for bit; float32 parameters and moments within rtol
    1e-6 (global_norm sums in another order, so the clip factor may be an
    ulp off)."""
    for k in LEAVES:
        if dt == "bfloat16":
            _bitwise(params[k], np.asarray(want_p[k]), f"adamw p {k} {s}")
        else:
            _close(params[k], want_p[k], 1e-6, f"adamw p {k} {s}")
        _close(opt["m"][k], want_opt["m"][k], 1e-6, f"adamw m {k} {s}")
        _close(opt["v"][k], want_opt["v"][k], 1e-6, f"adamw v {k} {s}")


def _post_gradient_half(jax_ref, case):
    arrays, ref = jax_ref
    dt, grad_scale, spec = CASES[case]
    ccfg = CompressionConfig.parse(spec)
    prog = train.orchestrator(N_DEV, 2, device="cpu").program
    reducer = train.make_step(ARCHS["qwen3-32b"].reduced(),
                              adamw.AdamWConfig(), prog, grad_scale, ccfg)
    params = {k: _to_torch(arrays[f"{case}/p/{k}"]) for k in LEAVES}
    ocfg = adamw.AdamWConfig()
    opt = adamw.init(params, ocfg)
    ef = {k: torch.zeros((N_DEV,) + s) for k, s in LEAVES.items()}
    tol = 1e-6 if dt == "float32" else 2 ** -7
    for s in range(2):
        sent = {}
        for k in LEAVES:
            g = _to_torch(arrays[f"{case}/g{s}/{k}"])
            sent[k] = torch.empty_like(g)
            for i in range(N_DEV):
                si, resid = compress_leaf(g[i], ef[k][i], ccfg)
                ef[k][i].copy_(resid)
                sent[k][i].copy_(si)
            _bitwise(sent[k], ref[f"{case}/{s}/sent/{k}"], f"sent {k} {s}")
            _bitwise(ef[k], ref[f"{case}/{s}/ef/{k}"], f"ef {k} {s}")
        grads = reducer.reduce(sent)
        for k in LEAVES:
            _bitwise(grads[k], ref[f"{case}/{s}/grad/{k}"], f"grad {k} {s}")
        want_p, want_opt, _ = _jax_adamw(grads, opt, params)
        params, opt, gn = adamw.update(grads, opt, params, ocfg)
        _assert_adamw_step(params, opt, want_p, want_opt, dt, s)
        np.testing.assert_allclose(float(gn), float(ref[f"{case}/{s}/gnorm"]),
                                   rtol=1e-6)
        for k in LEAVES:
            _close(params[k], ref[f"{case}/{s}/p/{k}"], tol, f"p {k} {s}")
            _close(opt["m"][k], ref[f"{case}/{s}/m/{k}"], 1e-6, f"m {k} {s}")
            _close(opt["v"][k], ref[f"{case}/{s}/v/{k}"], 1e-6, f"v {k} {s}")


@pytest.mark.parametrize("case", range(len(CASES)))
def test_post_gradient_half_matches_jax(jax_ref, case):
    _post_gradient_half(jax_ref, case)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_post_gradient_half_catches_unapplied_update(jax_ref, case,
                                                     monkeypatch):
    """A planted fault: AdamW updates the moments but never writes the
    parameters. The comparison with JAX's AdamW on the same inputs must
    catch it, in bfloat16 too, where an AdamW step is mostly smaller than
    a parameter's ulp."""
    real = adamw.update

    def unapplied(grads, opt, params, cfg, lr_scale=1.0):
        kept = T.tree_map(torch.clone, params)
        _, opt, gn = real(grads, opt, params, cfg, lr_scale)
        return kept, opt, gn

    monkeypatch.setattr(adamw, "update", unapplied)
    with pytest.raises(AssertionError, match="adamw p "):
        _post_gradient_half(jax_ref, case)


def test_whole_step_eight_workers_matches_jax(jax_ref):
    arrays, ref = jax_ref
    cfg = ARCHS["qwen3-32b"].reduced(**STEP_CFG)
    init = {k[len("step/init/"):]: v for k, v in ref.items()
            if k.startswith("step/init/")}
    params = api.params_from_jax(T.unflatten(init), "cpu")
    prog = train.orchestrator(N_DEV, 2, device="cpu").program
    ocfg = adamw.AdamWConfig()
    opt = adamw.init(params, ocfg)
    ef = T.tree_map(lambda p: torch.zeros((N_DEV,) + tuple(p.shape)), params)
    batch = {k: torch.as_tensor(arrays[k], dtype=torch.int64)
             for k in ("tokens", "labels")}
    params, opt, ef, met = train.make_step(cfg, ocfg, prog, 1.0)(
        params, opt, ef, batch)
    np.testing.assert_allclose(float(met["loss"]), float(ref["step/loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(ref["step/gnorm"]), rtol=1e-4)
    for k, p in T.leaves_with_paths(params):
        np.testing.assert_allclose(p.detach().numpy(), ref[f"step/p/{k}"],
                                   rtol=1e-4, atol=PARAM_ATOL, err_msg=k)


def test_whole_step_one_worker_matches_jax_make_step():
    jcfg = J_ARCHS["granite-20b"].reduced(**STEP_CFG)
    cfg = ARCHS["granite-20b"].reduced(**STEP_CFG)
    jparams = J_api.init_fn(jcfg)(jax.random.PRNGKey(1))
    params = api.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jtopo = J_train.dp_fleet(1)
    jprog = j_build_program(jtopo, np.zeros(jtopo.tree.n, bool))
    prog = train.orchestrator(1, 2, device="cpu").program
    assert prog.n_dev == jprog.n_dev == 1
    jocfg, ocfg = j_adamw.AdamWConfig(), adamw.AdamWConfig()
    jstep = J_train.make_step(jcfg, jocfg, None, jprog, 1.0)
    step = train.make_step(cfg, ocfg, prog, 1.0)
    jstate = (jparams, j_adamw.init(jparams, jocfg),
              jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                           jparams))
    state = (params, adamw.init(params, ocfg),
             T.tree_map(lambda p: torch.zeros(p.shape), params))
    jdata = JSyntheticLM(jcfg, JDataConfig(4, 16, seed=3))
    data = SyntheticLM(cfg, DataConfig(4, 16, seed=3), device="cpu")
    for s in range(2):
        *jstate, jmet = jstep(*jstate, jdata.batch(s))
        *state, met = step(*state, data.batch(s))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    jflat = dict(T.leaves_with_paths(jax.tree.map(np.asarray, jstate[0])))
    for k, p in T.leaves_with_paths(state[0]):
        np.testing.assert_allclose(p.detach().numpy(), jflat[k], rtol=1e-4,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scale_rounds_to_gradient_dtype_like_jax(dtype):
    """JAX converts the weakly typed ``grad_scale / n_dev`` to the
    gradients' dtype before it multiplies; a torch tensor times a Python
    float multiplies by the full-precision scalar."""
    rng = np.random.default_rng(5)
    g = jnp.asarray(rng.standard_normal(4096), jnp.dtype(dtype))
    scale = (8 / 7) / 8
    want = np.asarray(g * scale)
    tg = _to_torch(np.asarray(g))
    _bitwise(train.scaled(tg, scale), want, "scaled")
    if dtype == "bfloat16":       # the difference shows in bfloat16
        naive = _to_np(tg * scale)
        assert not np.array_equal(_np_bits(naive), _np_bits(want))


@pytest.mark.parametrize("name,seed", [("qwen3-32b", 0), ("granite-20b", 7)])
def test_synthetic_batches_bitwise(name, seed):
    jdata = JSyntheticLM(J_ARCHS[name], JDataConfig(4, 33, seed=seed))
    data = SyntheticLM(ARCHS[name], DataConfig(4, 33, seed=seed),
                       device="cpu")
    for step in (0, 1, 17):
        for host in ((0, 1), (1, 2)):
            jb, b = jdata.batch(step, *host), data.batch(step, *host)
            for k in ("tokens", "labels"):
                assert b[k].dtype == torch.int64
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


def _state_tree(rng):
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "layers": {"b": np.asarray(jnp.asarray(
                           rng.standard_normal((2, 5)), jnp.bfloat16))}},
            "opt": {"step": np.int32(7),
                    "m": rng.standard_normal(6).astype(np.float32)},
            "list": [rng.standard_normal(2).astype(np.float32)]}


def test_checkpoints_cross_restore_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    tree = _state_tree(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = T.tree_map(lambda a: _to_torch(np.asarray(a)), tree)
    # JAX writes, the port reads
    j_ckpt.save(tmp_path / "j", 4, jtree, extra={"who": "jax"})
    assert ckpt.latest_step(tmp_path / "j") == 4
    got, step = ckpt.restore(tmp_path / "j", ttree)
    assert step == 4
    for (k, a), (_, b) in zip(T.leaves_with_paths(got),
                              T.leaves_with_paths(tree)):
        _bitwise(a, np.asarray(b), k)
    # the port writes, JAX reads; the same files
    ckpt.save(tmp_path / "t", 4, ttree, extra={"who": "jax"})
    jgot, _ = j_ckpt.restore(tmp_path / "t", jtree)
    for (k, a), (_, b) in zip(T.leaves_with_paths(jax.tree.map(
            np.asarray, jgot)), T.leaves_with_paths(tree)):
        assert a.dtype == np.asarray(b).dtype
        assert np.array_equal(_np_bits(a), _np_bits(np.asarray(b))), k
    for d in ("j", "t"):
        files = np.load(tmp_path / d / "step_00000004" / "arrays.npz")
        assert sorted(files.files) == ["list/0", "opt/m", "opt/step",
                                       "params/layers/b::bf16", "params/w"]
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path / "j", {**ttree, "list": [torch.zeros(3)]})


def test_checkpoint_manager_keeps_n_and_snapshots(tmp_path):
    t = {"w": torch.zeros(3)}
    mgr = ckpt.CheckpointManager(tmp_path, keep_n=2)
    for s in range(4):
        mgr.save(s, t)
        t["w"].add_(1.0)          # after save: the snapshot is unaffected
    mgr.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003"]
    got, step = ckpt.restore(tmp_path, t)
    assert step == 3 and got["w"].tolist() == [3.0, 3.0, 3.0]


def test_main_program_equals_orchestrator():
    jprog = Orchestrator(J_train.dp_fleet(N_DEV),
                         OrchestratorConfig(k=2, strategy="soar")).program
    prog = train.orchestrator(N_DEV, 2, device="cpu").program
    assert (prog.n_dev, prog.n_slots, prog.root_home, prog.root_count) == (
        jprog.n_dev, jprog.n_slots, jprog.root_home, jprog.root_count)
    assert prog.utilization == jprog.utilization
    assert prog.total_network_messages == jprog.total_network_messages
    assert len(prog.ops) == len(jprog.ops)
    for x, y in zip(prog.ops, jprog.ops):
        assert type(x).__name__ == type(y).__name__
        for name, vx in vars(x).items():
            vy = getattr(y, name)
            if isinstance(vx, np.ndarray):
                assert vx.dtype == vy.dtype and np.array_equal(vx, vy), name
            else:
                assert vx == vy, name
    for n in (1, 2, 4, 6, 8, 16):
        a, b = train.dp_fleet(n), J_train.dp_fleet(n)
        assert a.n_devices == b.n_devices == n
        assert np.array_equal(a.tree.parent, b.tree.parent)


def _ckpt_arrays(d, step):
    return dict(np.load(Path(d) / f"step_{step:08d}" / "arrays.npz"))


def test_main_trains_and_resumes_bitwise(tmp_path, capsys):
    args = ["--reduced", "--device", "cpu", "--n-dev", "4",
            "--global-batch", "4", "--seq", "16", "--steps", "5",
            "--compress", "topk:0.05", "--ckpt-every", "3", "--log-every", "1"]
    full = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    assert len(full) == 5 and np.isfinite(full).all()
    assert ckpt.latest_step(tmp_path / "a") == 5
    # resume from the step-3 checkpoint in a fresh directory
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed == full[3:]
    a, b = _ckpt_arrays(tmp_path / "a", 5), _ckpt_arrays(tmp_path / "b", 5)
    assert sorted(a) == sorted(b)
    assert any(k.startswith("ef/") for k in a)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_parse_failures_and_mask_dead_batch_match_jax():
    for spec in (None, "", "30:0,1;60:5", "3:7"):
        assert train.parse_failures(spec) == J_train.parse_failures(spec)
    rng = np.random.default_rng(6)
    toks = rng.integers(1, 50, size=(8, 5)).astype(np.int32)
    w = rng.integers(1, 50, size=8).astype(np.int32)
    alive = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    want = J_train.mask_dead_batch({"tokens": jnp.asarray(toks),
                                    "w": jnp.asarray(w)}, alive, 8, 4)
    got = train.mask_dead_batch({"tokens": torch.as_tensor(toks),
                                 "w": torch.as_tensor(w)}, alive, 8, 4)
    for k in ("tokens", "w"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    batch = {"tokens": torch.as_tensor(toks)}
    assert train.mask_dead_batch(batch, np.ones(4, bool), 8, 4) is batch


def test_main_rejects_fail_and_bad_batch():
    """A failure the orchestrator refuses stops ``main`` before its step
    (``--fail`` itself runs through the orchestrator now)."""
    base = ["--reduced", "--device", "cpu", "--n-dev", "4", "--global-batch",
            "4", "--seq", "8", "--steps", "1"]
    with pytest.raises(ValueError, match="device 9 out of range"):
        train.main(base + ["--fail", "0:9"])
    with pytest.raises(RuntimeError, match="all devices failed"):
        train.main(base + ["--fail", "0:0,1,2,3"])
    with pytest.raises(SystemExit, match="split"):
        train.main(["--reduced", "--device", "cpu", "--n-dev", "3"])
    assert dataclasses.asdict(train.config_from_args(
        type("A", (), {"arch": "qwen3-32b", "preset_100m": True,
                       "reduced": False})())) == dataclasses.asdict(
        J_ARCHS["qwen3-32b"].reduced(n_layers=8, d_model=512, n_heads=8,
                                     n_kv_heads=8, d_ff=2048, vocab=32_768,
                                     head_dim=0))


FAIL_ARGS = ["--reduced", "--device", "cpu", "--n-dev", "4", "--global-batch",
             "4", "--seq", "16", "--steps", "5", "--compress", "topk:0.05",
             "--log-every", "1"]


class _Steps:
    """Records the (program, grad_scale) of every step ``main`` builds."""

    def __init__(self, monkeypatch):
        self.built = []
        real = train.make_step

        def make_step(cfg, ocfg, prog, grad_scale, ccfg=CompressionConfig()):
            self.built.append((prog, grad_scale))
            return real(cfg, ocfg, prog, grad_scale, ccfg)

        monkeypatch.setattr(train, "make_step", make_step)


def test_main_fail_replans_like_the_jax_orchestrator(monkeypatch, capsys):
    steps = _Steps(monkeypatch)
    losses = train.main(FAIL_ARGS + ["--fail", "2:0"])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert "[step 2] failure [0] -> replanned" in capsys.readouterr().out
    assert len(steps.built) == 2
    jorch = Orchestrator(J_train.dp_fleet(4), OrchestratorConfig(k=2))
    _same_program(jorch.program, steps.built[0][0])
    assert steps.built[0][1] == jorch.grad_scale == 1.0
    jorch.on_failure([0])
    prog, grad_scale = steps.built[1]
    _same_program(jorch.program, prog)
    assert grad_scale == jorch.grad_scale == 4 / 3
    assert prog.n_dev == 4


def _direct_run(fail_step, dead, steps=5):
    """``main``'s run built by hand: the pristine program before
    ``fail_step``, the orchestrator's after it, dead shards zeroed."""
    cfg = ARCHS["qwen3-32b"].reduced()
    ocfg, ccfg = adamw.AdamWConfig(), CompressionConfig.parse("topk:0.05")
    orch = train.orchestrator(4, 2, device="cpu")
    params = api.init_fn(cfg, "cpu")(0)
    opt = adamw.init(params, ocfg)
    ef = T.tree_map(lambda e: e.new_zeros((4,) + tuple(e.shape)),
                    init_error_feedback(params))
    data = SyntheticLM(cfg, DataConfig(4, 16, seed=0), device="cpu")
    step = train.make_step(cfg, ocfg, orch.program, orch.grad_scale, ccfg)
    losses = []
    for s in range(steps):
        if s == fail_step:
            orch.on_failure(dead)
            step = train.make_step(cfg, ocfg, orch.program, orch.grad_scale,
                                   ccfg)
        batch = train.mask_dead_batch(data.batch(s), orch.alive, 4, 4)
        params, opt, ef, met = step(params, opt, ef, batch)
        losses.append(float(met["loss"]))
    return losses


def test_main_fail_losses_equal_a_direct_run():
    got = train.main(FAIL_ARGS + ["--fail", "2:0,3"])
    assert got == _direct_run(2, [0, 3])
    assert got[:2] == train.main(FAIL_ARGS + ["--steps", "2"])


def test_dead_workers_sent_rows_are_not_read():
    """A planted nonzero in a dead worker's row of the stacked sent
    gradients leaves the reduced gradient unchanged, bit for bit; in a
    live worker's row it changes it."""
    orch = train.orchestrator(4, 2, device="cpu")
    orch.on_failure([1, 2])
    step = train.make_step(ARCHS["qwen3-32b"].reduced(), adamw.AdamWConfig(),
                           orch.program, orch.grad_scale)
    rng = np.random.default_rng(8)
    sent = {k: torch.as_tensor(rng.standard_normal((4,) + s),
                               dtype=torch.float32)
            for k, s in LEAVES.items()}
    want = step.reduce({k: v.clone() for k, v in sent.items()})
    for row, same in ((1, True), (2, True), (0, False)):
        planted = {k: v.clone() for k, v in sent.items()}
        for v in planted.values():
            v[row] = 1e6
        got = step.reduce(planted)
        for k in LEAVES:
            assert torch.equal(got[k], want[k]) == same, (row, k)


def test_main_resume_replays_earlier_failures(tmp_path):
    args = FAIL_ARGS + ["--fail", "2:1", "--ckpt-every", "3"]
    full = train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert resumed == full[3:]
    a, b = _ckpt_arrays(tmp_path / "a", 5), _ckpt_arrays(tmp_path / "b", 5)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-ref"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    else:
        sys.exit("usage: test_torch_train.py --jax-ref IN.npz OUT.npz")
