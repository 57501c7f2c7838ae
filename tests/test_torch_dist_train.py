"""The port's trainer and ``ChaosTrainer`` one rank per worker, on gloo CPU
ranks, vs their single-process forms; the mesh helpers vs the JAX
package's.

One spawn of 4 ranks for the module (this file run as ``python
tests/test_torch_dist_train.py --ranks IN OUT``; the group initialised
from a ``file://`` store in a temporary directory, no port), each rank on
one thread. They run, at reduced qwen3-32b on the CPU:

* ``train.main`` for 3 steps without compression, with ``topk:0.01``, and
  with ``--fail "1:0"`` (top-k too): the losses on every rank and the
  final checkpoint (params, AdamW moments, the error-feedback rows
  gathered to ``(n_dev, ...)``) bitwise equal to ``main --n-dev 4 --device
  cpu``'s, which simulates the 4 workers in one process; the distributed
  trainer is held against the simulated one, which
  ``tests/test_torch_train.py`` holds per worker against JAX (the JAX
  multi-device step is no reference, ROADMAP C8);
* checkpoints across the two forms: a distributed run resumed from a
  simulated run's step-2 checkpoint and a simulated run resumed from a
  distributed run's both end bitwise where the uninterrupted run ends;
* ``ChaosTrainer`` over ``dp_fleet(4)`` through
  ``tests/helpers/degraded_check.py``'s 8 events (blue degrades, two
  crashes, a failed and recovered device): every record (but its
  seconds) equal to the single-process trainer's, its lossless steps
  bitwise the pristine program's on every rank (the trainer raises
  otherwise), the restores bitwise;
* the mesh helpers on 2 x 2, 4 x 1 and 1 x 4 meshes and the 1-D data
  mesh: axis sizes, data-parallel axes and size equal to the JAX
  helpers' on 4 fake CPU devices (one JAX subprocess);
* the refusals: ``--n-dev`` other than the world size, a ``ChaosTrainer``
  whose group is not its fleet's size.

``make_production_mesh`` (256 or 512 ranks) is held to the JAX helper's
shape and axis names by recording the calls. An NCCL run that would put
two ranks on one card raises before any process group exists.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.engine import EngineOptions
from repro_torch.launch import mesh as M
from repro_torch.launch import train
from repro_torch.launch.train import dp_fleet

ROOT = Path(__file__).resolve().parents[1]
N = 4
BASE = ["--reduced", "--device", "cpu", "--global-batch", "8", "--seq",
        "16", "--log-every", "100"]
CONFIGS = {"plain": [], "topk": ["--compress", "topk:0.01"],
           "fail": ["--compress", "topk:0.01", "--fail", "1:0"]}
MESHES = [(2, 2), (4, 1), (1, 4)]
RECORD_SKIP = ("step_seconds",)


def _events(orch):
    """``tests/helpers/degraded_check.py``'s events over ``orch``'s blue
    switches."""
    from repro_torch.runtime import FaultEvent
    blue = [int(s) for s in np.nonzero(orch.blue)[0]]
    return [FaultEvent("degrade_switch", rates=((blue[0], 0.5),)),
            FaultEvent("degrade_switch", rates=((blue[1], 0.25),)),
            FaultEvent("crash"),
            FaultEvent("recover_switch_capacity", rates=((blue[0], 1.0),)),
            FaultEvent("fail_device", devices=(3,)),
            FaultEvent("crash"),
            FaultEvent("recover_device", devices=(3,)),
            FaultEvent("recover_switch_capacity", rates=((blue[1], 1.0),))]


def _chaos(ckpt_dir, group=None):
    """A ``ChaosTrainer`` over ``dp_fleet(4)`` (simulated workers without
    ``group``) through the events; returns its records and summary."""
    from repro_torch.runtime import (ChaosHarness, ChaosTrainer,
                                     Orchestrator, OrchestratorConfig)
    o = Orchestrator(dp_fleet(N), OrchestratorConfig(k=2),
                     options=EngineOptions(device="cpu"))
    tr = ChaosTrainer(o, seq=16, global_batch=N, ckpt_dir=str(ckpt_dir),
                      ckpt_every=2, group=group)
    report = ChaosHarness(o, trainer=tr).run(_events(o))
    records = [{k: v for k, v in r.items() if k not in RECORD_SKIP}
               for r in report.records]
    # as JSON holds them (numpy scalars as Python numbers, tuples as lists)
    return json.loads(json.dumps([records, tr.summary(),
                                  report.invariant_checks],
                                 default=lambda v: v.item()))


# -- the rank bodies (this file run as a script) ------------------------------

def _rank_body(rank: int, world: int, store: str, work: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    work = Path(work)
    out = {}
    try:
        meshes = {}
        for a, b in MESHES:
            m = M.make_test_mesh(a, b, device_type="cpu")
            meshes[f"{a}x{b}"] = [M.mesh_axis_sizes(m), list(M.dp_axes(m)),
                                  M.dp_size(m)]
        dp = M.make_dp_mesh(world, device_type="cpu")
        meshes["dp"] = [M.mesh_axis_sizes(dp), list(M.dp_axes(dp)),
                        M.dp_size(dp)]
        out["meshes"] = meshes
        for name, extra in CONFIGS.items():
            out[name] = train.main(BASE + extra + [
                "--steps", "3", "--ckpt-dir", str(work / f"dist-{name}")])
        # resumed from the simulated run's step-2 checkpoint
        out["resumed"] = train.main(BASE + CONFIGS["topk"] + [
            "--steps", "3", "--resume", "--ckpt-dir", str(work / "from-sim")])
        # 2 steps, for the simulated run to resume from
        train.main(BASE + CONFIGS["topk"] + [
            "--steps", "2", "--ckpt-dir", str(work / "to-sim")])
        try:
            train.main(BASE + ["--steps", "1", "--n-dev", "3"])
        except SystemExit as e:
            out["n_dev_error"] = str(e)
        group = dp.get_group("data")
        out["chaos"] = _chaos(work / "chaos", group)
        from repro_torch.runtime import (ChaosTrainer, Orchestrator,
                                         OrchestratorConfig)
        o8 = Orchestrator(dp_fleet(8), OrchestratorConfig(k=2),
                          options=EngineOptions(device="cpu"))
        try:
            ChaosTrainer(o8, seq=16, global_batch=8, group=group)
        except ValueError as e:
            out["chaos_size_error"] = str(e)
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, work: str) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(world, os.path.join(tmp, "store"), work),
                 nprocs=world)


# -- the JAX mesh helpers (this file run as a script) -------------------------

def _jax_meshes(fout: str) -> None:
    import jax

    from repro.launch import mesh as JM
    assert jax.device_count() == N, jax.device_count()
    out = {}
    for a, b in MESHES:
        m = JM.make_test_mesh(a, b)
        out[f"{a}x{b}"] = [JM.mesh_axis_sizes(m), list(JM.dp_axes(m)),
                           JM.dp_size(m)]
    m = jax.make_mesh((N,), ("data",))
    out["dp"] = [JM.mesh_axis_sizes(m), list(JM.dp_axes(m)), JM.dp_size(m)]
    Path(fout).write_text(json.dumps(out))


# -- fixtures -----------------------------------------------------------------

def _ckpt(d, step):
    return dict(np.load(Path(d) / f"step_{step:08d}" / "arrays.npz"))


@pytest.fixture(scope="module")
def runs():
    """The 4 ranks' results and the single-process runs (the ranks and the
    JAX subprocess run while this process trains the simulated forms)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = Path(tempfile.mkdtemp(prefix="dist_train_"))
    try:
        # the simulated run the distributed one resumes from
        train.main(BASE + CONFIGS["topk"] + ["--n-dev", str(N), "--steps",
                                             "2", "--ckpt-dir",
                                             str(tmp / "from-sim")])
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={N}")
        ranks = subprocess.Popen(
            [sys.executable, __file__, "--ranks", str(N), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        jax_p = subprocess.Popen(
            [sys.executable, __file__, "--jax-meshes",
             str(tmp / "jax.json")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
        sim = {name: train.main(BASE + extra + [
            "--n-dev", str(N), "--steps", "3", "--ckpt-dir",
            str(tmp / f"sim-{name}")]) for name, extra in CONFIGS.items()}
        sim_chaos = _chaos(tmp / "sim-chaos")
        _, rerr = ranks.communicate(timeout=300)
        _, jerr = jax_p.communicate(timeout=300)
        assert ranks.returncode == 0, rerr[-4000:]
        assert jax_p.returncode == 0, jerr[-4000:]
        # the simulated run resumed from the distributed run's step 2
        sim["resumed"] = train.main(BASE + CONFIGS["topk"] + [
            "--n-dev", str(N), "--steps", "3", "--resume", "--ckpt-dir",
            str(tmp / "to-sim")])
        got = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(N)]
        ckpts = {name: _ckpt(tmp / name, 3) for name in
                 [f"sim-{c}" for c in CONFIGS] + [f"dist-{c}" for c in CONFIGS]
                 + ["from-sim", "to-sim"]}
        jax_meshes = json.loads((tmp / "jax.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.set_num_threads(n)
    return got, sim, sim_chaos, ckpts, jax_meshes


def _same_arrays(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what,
                                                                       k)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_distributed_main_equals_simulated_bitwise(runs, name):
    got, sim, _, ckpts, _ = runs
    assert len(sim[name]) == 3 and np.isfinite(sim[name]).all()
    for r in range(N):
        assert got[r][name] == sim[name], (name, r)
    a, b = ckpts[f"dist-{name}"], ckpts[f"sim-{name}"]
    _same_arrays(a, b, name)
    assert any(k.startswith("ef/") for k in a)
    assert any(k.startswith("opt/") for k in a)
    assert all(a[k].shape[0] == N for k in a if k.startswith("ef/"))
    if name != "plain":          # top-k leaves a residual in every row
        for k in a:
            if k.startswith("ef/") and a[k].size > N * 100:
                rows = a[k].reshape(N, -1)
                assert all(np.any(rows[i] != 0) for i in range(N)), k


def test_failure_replans_on_every_rank(runs):
    """The failed worker's shard is zeroed and the program changes: the
    losses part from the run without the failure after step 1."""
    got, sim, *_ = runs
    assert got[0]["fail"][:1] == got[0]["topk"][:1]
    assert got[0]["fail"][1:] != got[0]["topk"][1:]


def test_checkpoints_interchange_bitwise(runs):
    got, sim, _, ckpts, _ = runs
    for r in range(N):
        assert got[r]["resumed"] == sim["topk"][2:]
    assert sim["resumed"] == sim["topk"][2:]
    _same_arrays(ckpts["from-sim"], ckpts["sim-topk"], "dist from sim")
    _same_arrays(ckpts["to-sim"], ckpts["sim-topk"], "sim from dist")


def test_chaos_trainer_ranks_equal_single_process(runs):
    got, _, (records, summary, checks), _, _ = runs
    assert len(records) == 8 and checks == 8
    assert summary["restores"] == 2 and summary["bitwise_checks"] >= 2
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 5, 6, 7]
    for r in range(N):
        d_records, d_summary, d_checks = got[r]["chaos"]
        assert d_checks == checks
        assert d_records == records, r
        for key in ("steps", "restores", "bitwise_checks", "compiles",
                    "first_loss", "last_loss"):
            assert d_summary[key] == summary[key], (r, key)


def test_refusals(runs):
    got, *_ = runs
    for r in range(N):
        assert "--n-dev 3 != the world size 4" in got[r]["n_dev_error"]
        assert "8 devices but the group 4 ranks" in got[r]["chaos_size_error"]


def test_mesh_helpers_equal_jax(runs):
    got, *_, jax_meshes = runs
    assert set(jax_meshes) == {"2x2", "4x1", "1x4", "dp"}
    for r in range(N):
        assert got[r]["meshes"] == jax_meshes
    assert jax_meshes["2x2"] == [{"data": 2, "model": 2}, ["data"], 2]


def test_production_mesh_shape_and_axes(monkeypatch):
    """The same shapes and axis names as the JAX helper (256 and 512
    ranks cannot run here: the calls are recorded)."""
    import jax

    from repro.launch import mesh as JM
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: calls[
        "jax"].append((tuple(shape), tuple(axes))))
    monkeypatch.setattr(M, "init_device_mesh", lambda dev, shape,
                        mesh_dim_names: calls["port"].append(
                            (tuple(shape), tuple(mesh_dim_names))))
    for multi_pod in (False, True):
        JM.make_production_mesh(multi_pod=multi_pod)
        M.make_production_mesh(multi_pod=multi_pod)
    assert calls["jax"] == calls["port"] == [
        ((16, 16), ("data", "model")),
        ((2, 16, 16), ("pod", "data", "model"))]


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """Before any process group or card is touched."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="NCCL cannot run two ranks on one "
                                         "card"):
        train.rank_device("cuda:0", "nccl")
    with pytest.raises(ValueError, match="needs --dist-backend gloo"):
        train.rank_device("cpu", "nccl")
    assert train.rank_device("cpu", None) == (torch.device("cpu"), "gloo")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.rank_device("cuda:0", "gloo")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.rank_device(None, None)     # cuda:1 under NCCL


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks"]:
        _spawn(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--jax-meshes"]:
        _jax_meshes(sys.argv[2])
    else:
        sys.exit("usage: test_torch_dist_train.py --ranks N WORK | "
                 "--jax-meshes OUT")
