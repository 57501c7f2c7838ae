"""The port's training-coupled chaos (``repro_torch.runtime.ChaosTrainer``)
on the CPU vs the JAX package's.

* One worker (``tests/test_faults.py``'s single-device case): the JAX
  ``ChaosTrainer`` and the port's, the port's parameters loaded from the
  JAX trainer's, through the same events over a ``Twin`` of orchestrators.
  Every record key but ``step_seconds`` equal, the orchestrators' whole
  state equal after every event, and ``summary()`` equal in steps,
  restores, bitwise checks and compiles. The trainer's model is
  ``ARCHS["qwen3-32b"].reduced()``, in bfloat16: its losses are held to
  rtol 2e-2, what ``test_torch_model.py`` holds a bfloat16 model's loss to
  (the two frameworks round at other places; the first loss already
  differs by 1.5e-5). The same run with the config's dtype set to float32
  holds every loss to rtol 1e-5, what ``test_torch_train.py`` holds a
  whole float32 step's loss to.
* Eight workers (the event list of ``tests/helpers/degraded_check.py``,
  which the JAX package cannot run under the installed JAX, ROADMAP C3):
  the port's own bitwise checks (lossless steps under degraded, spilling
  programs equal to the pristine program's) and checkpoint restores, with
  the orchestrator's records and state equal to a JAX harness's run of the
  same events without a trainer.
* Planted faults: the live step's ``grad_scale`` one bfloat16 ulp off on a
  lossless event, and one byte of a saved leaf changed before a crash,
  must raise ``InvariantViolation``; a crash without a checkpoint
  directory too.
"""
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro_torch.runtime as TR
from repro.configs import ARCHS as J_ARCHS
from repro.launch.train import dp_fleet as j_dp_fleet
from repro_torch import tree as T
from repro_torch.configs import ARCHS
from repro_torch.engine import EngineOptions
from repro_torch.launch.train import dp_fleet
from repro_torch.models import api
from test_torch_chaos import same_record
from test_torch_runtime import Twin

CPU = EngineOptions(device="cpu")
# a loss by the model's dtype: test_torch_train.py holds a float32 step,
# test_torch_model.py a bfloat16 model
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
_ORCH_KEYS = ("kind", "utilization", "cache_hit", "n_alive", "replans")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def single_device_events(orch):
    blues = np.nonzero(orch.blue)[0]
    s = int(blues[0]) if len(blues) else 0     # 1-device fleets go all-red
    return [TR.FaultEvent("degrade_switch", rates=((s, 0.5),)),
            TR.FaultEvent("degrade_switch", rates=((s, 0.25),)),
            TR.FaultEvent("crash"),
            TR.FaultEvent("recover_switch_capacity", rates=((s, 1.0),)),
            TR.FaultEvent("crash")]


def eight_worker_events(orch):
    """``tests/helpers/degraded_check.py``'s events."""
    blue = [int(s) for s in np.nonzero(orch.blue)[0]]
    return [TR.FaultEvent("degrade_switch", rates=((blue[0], 0.5),)),
            TR.FaultEvent("degrade_switch", rates=((blue[1], 0.25),)),
            TR.FaultEvent("crash"),
            TR.FaultEvent("recover_switch_capacity", rates=((blue[0], 1.0),)),
            TR.FaultEvent("fail_device", devices=(3,)),
            TR.FaultEvent("crash"),
            TR.FaultEvent("recover_device", devices=(3,)),
            TR.FaultEvent("recover_switch_capacity", rates=((blue[1], 1.0),))]


def to_jax(ev):
    return JR.FaultEvent(**dataclasses.asdict(ev))


def trainer8(ckpt_dir, **kw):
    orch = TR.Orchestrator(dp_fleet(8), TR.OrchestratorConfig(k=2),
                           options=CPU)
    tr = TR.ChaosTrainer(orch, seq=16, global_batch=8, ckpt_dir=ckpt_dir,
                         ckpt_every=2, **kw)
    return orch, tr, TR.ChaosHarness(orch, trainer=tr)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_single_device_matches_jax(tmp_path, monkeypatch, dtype):
    assert jax.device_count() == 1
    for archs in (J_ARCHS, ARCHS):          # what ChaosTrainer reduces
        monkeypatch.setitem(archs, "qwen3-32b", dataclasses.replace(
            archs["qwen3-32b"], dtype=dtype))
    n = j_dp_fleet(1).tree.n
    tw = Twin(j_dp_fleet(1), dp_fleet(1), k=min(2, n))
    jtr = JR.ChaosTrainer(tw.j, seq=16, global_batch=4,
                          ckpt_dir=str(tmp_path / "jax"), ckpt_every=2)
    tr = TR.ChaosTrainer(tw.t, seq=16, global_batch=4,
                         ckpt_dir=str(tmp_path / "port"), ckpt_every=2)
    # the port starts from the JAX trainer's parameters (its own seeded
    # init draws other numbers), saved again as its step-0 checkpoint
    want = dict(T.leaves_with_paths(api.params_from_jax(
        jax.tree.map(np.asarray, jtr.params), "cpu")))
    with torch.no_grad():
        for path, p in T.leaves_with_paths(tr.params):
            assert p.dtype == want[path].dtype
            p.copy_(want[path])
    tr._save()
    assert tr.cfg.dtype == jtr.cfg.dtype == dtype
    jh = JR.ChaosHarness(tw.j, trainer=jtr)
    th = TR.ChaosHarness(tw.t, trainer=tr)
    for ev in single_device_events(tw.t):
        a, b = jh.step(to_jax(ev)), th.step(ev)
        assert list(a) == list(b)
        np.testing.assert_allclose(b["loss"], a["loss"],
                                   rtol=LOSS_RTOL[dtype])
        same_record({k: v for k, v in a.items()
                     if k not in ("loss", "step_seconds")},
                    {k: v for k, v in b.items()
                     if k not in ("loss", "step_seconds")})
        tw.check()
    ja, ta = jtr.summary(), tr.summary()
    for key in ("steps", "restores", "bitwise_checks", "compiles"):
        assert ja[key] == ta[key], key
    assert ta["steps"] == 5 and ta["restores"] == 2
    assert ta["bitwise_checks"] >= 1
    assert jh.invariant_checks == th.invariant_checks == 5
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=LOSS_RTOL[dtype])


def test_eight_workers_bitwise_checks_and_restores(tmp_path):
    tw = Twin(j_dp_fleet(8), dp_fleet(8), k=2)
    tr = TR.ChaosTrainer(tw.t, seq=16, global_batch=8,
                         ckpt_dir=str(tmp_path), ckpt_every=2)
    jh = JR.ChaosHarness(tw.j)
    th = TR.ChaosHarness(tw.t, trainer=tr)
    events = eight_worker_events(tw.t)
    records = []
    for ev in events:
        a, b = jh.step(to_jax(ev)), th.step(ev)
        same_record(a, {k: b[k] for k in _ORCH_KEYS})
        tw.check()
        records.append(b)
    s = tr.summary()
    assert s["steps"] == len(events) == th.invariant_checks
    assert s["restores"] == 2
    assert s["bitwise_checks"] >= 2
    # the two blue degrades keep the placement and every worker
    assert [r["bitwise_checked"] for r in records[:2]] == [True, True]
    assert records[1]["utilization"] > records[0]["utilization"] > \
        tw.t.utilization_history[0]
    assert all(np.isfinite([r["loss"] for r in records]))
    # a crash rewinds to the last checkpoint (every 2 steps)
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 5, 6, 7]


def test_reference_step_leaves_the_live_state_alone(tmp_path):
    """The pristine step runs on copies: a bitwise-checked lossless step
    leaves the trainer where an unchecked step does."""
    _, tr, h = trainer8(str(tmp_path / "a"))
    _, plain, _ = trainer8(str(tmp_path / "b"))
    blue = int(np.nonzero(tr.orch.blue)[0][0])
    ev = TR.FaultEvent("degrade_switch", rates=((blue, 0.5),))
    assert h.step(ev)["bitwise_checked"]
    plain.orch.on_switch_degrade({blue: 0.5})
    plain.train_step(check_bitwise=False)
    TR.faults._assert_trees_bitwise(tr._state(), plain._state(), "live")
    assert tr.bitwise_checks == 1 and tr.step_no == plain.step_no == 1


def _nudged(tr, up):
    """The trainer's live step (not the pristine one) on ``up(grad_scale)``."""
    real = tr._step_fn

    def step_fn(program, grad_scale, pristine=False):
        return real(program, grad_scale if pristine else up(grad_scale),
                    pristine)

    tr._step_fn = step_fn


def _bf16_ulp_up(grad_scale, n_dev=8):
    """``grad_scale`` moved so that ``grad_scale / n_dev`` rounded to
    bfloat16 (the gradients' dtype) is one ulp larger."""
    s = torch.tensor(grad_scale / n_dev, dtype=torch.bfloat16)
    up = (s.view(torch.int16) + 1).view(torch.bfloat16)
    return float(up) * n_dev


def test_planted_grad_scale_ulp_raises(tmp_path):
    _, tr, h = trainer8(str(tmp_path))
    _nudged(tr, _bf16_ulp_up)
    blue = int(np.nonzero(tr.orch.blue)[0][0])
    with pytest.raises(TR.InvariantViolation, match="lossless step 0"):
        h.step(TR.FaultEvent("degrade_switch", rates=((blue, 0.5),)))


def test_float32_ulp_of_grad_scale_rounds_away(tmp_path):
    """One float32 ulp of ``grad_scale`` is lost when the scale is rounded
    to the bfloat16 gradients' dtype (as JAX rounds a weakly typed
    scalar): the step is bitwise the pristine one, and the check passes."""
    _, tr, h = trainer8(str(tmp_path))
    _nudged(tr, lambda g: float(np.nextafter(np.float32(g),
                                             np.float32(np.inf))))
    blue = int(np.nonzero(tr.orch.blue)[0][0])
    assert h.step(TR.FaultEvent("degrade_switch",
                                rates=((blue, 0.5),)))["bitwise_checked"]


def flip_saved_byte(ckpt_dir, step, leaf=3):
    """Change one byte of the ``leaf``-th array of a saved checkpoint."""
    path = pathlib.Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz"
    arrays = dict(np.load(path))
    key = sorted(arrays)[leaf]
    a = arrays[key].copy()
    a.reshape(-1).view(np.uint8)[0] ^= 1
    arrays[key] = a
    np.savez(path, **arrays)
    return key


def test_planted_checkpoint_byte_raises(tmp_path):
    _, tr, h = trainer8(str(tmp_path))
    h.step(TR.FaultEvent("recover_quarantined"))
    h.step(TR.FaultEvent("recover_quarantined"))       # saves step 2
    flip_saved_byte(tmp_path, 2)
    with pytest.raises(TR.InvariantViolation,
                       match="checkpoint restore at step 2: leaf"):
        h.step(TR.FaultEvent("crash"))


def test_crash_without_checkpoint_dir_raises():
    _, tr, h = trainer8(None)
    assert tr.mgr is None
    with pytest.raises(TR.InvariantViolation, match="checkpoint"):
        h.step(TR.FaultEvent("crash"))


def test_trainer_validates_batch_split():
    orch = TR.Orchestrator(dp_fleet(8), TR.OrchestratorConfig(k=2),
                           options=CPU)
    with pytest.raises(ValueError, match="not divisible by 8 devices"):
        TR.ChaosTrainer(orch, global_batch=12)
    tr = TR.ChaosTrainer(orch)
    assert tr.global_batch == 8 and tr.device == torch.device("cpu")
    assert T.leaves(tr.ef)[0].shape[0] == 8
