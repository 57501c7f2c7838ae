"""The port's single-card reduce executor on the CPU vs the JAX package.

``repro_torch.collectives.tree_allreduce`` runs a ``ReduceProgram`` over all
devices' buffers on one device. On CPU tensors every Reduce takes the plain
segment sum. It is held, bitwise:

* against ``_run_host``, a copy of the numpy interpreter of the JAX
  package's ``tests/test_degraded_capacity.py``, on every pristine and
  degraded program of that file's random sweep;
* against the JAX shard_map executor itself, on 8 fake CPU devices in one
  subprocess (this file run as ``python tests/test_torch_executor.py
  --jax-ref IN OUT``; the device count must be set before JAX starts), on
  three programs of ``chip_level_tree(2, 2, 2)``: SOAR at k = 2, all red,
  and a degraded program with FoldOp and CompactOp rounds, in float32 and
  in bfloat16. The JAX executor runs under ``jax.jit``, as a training step
  calls it.

Inputs are standard normal float32, so no sum is zero and equal values
are equal bytes.
"""
import importlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.collectives as T
from repro_torch.collectives.schedule import (CompactOp, CompressOp, FoldOp,
                                              PermuteRound)
from repro_torch.collectives.tree_allreduce import (compile_program,
                                                    device_program)
from repro_torch.core.reduce import all_red
from repro_torch.engine import EngineOptions
from repro_torch.kernels.segment_reduce.segment_reduce import (
    segment_reduce_cuda)

ROOT = Path(__file__).resolve().parents[1]
CPU = EngineOptions(device="cpu")
DIMS = [(1, 2, 2), (2, 2, 2), (1, 4, 2), (2, 2, 4)]


def _run_host(prog, x):
    """Numpy interpreter mirroring the executor's arithmetic exactly
    (float32 strict sequential left folds); a copy of the JAX package's
    ``tests/test_degraded_capacity.py::_run_host``."""
    n_dev, d = x.shape
    buf = np.zeros((n_dev, prog.n_slots, d), np.float32)
    buf[:, 0] = x
    for op in prog.ops:
        if isinstance(op, PermuteRound):
            old = buf.copy()
            for (s, dst) in op.perm:
                off = int(op.recv_offset[dst])
                cnt = int(op.recv_count[dst])
                buf[dst, off:off + cnt] += old[s, :cnt]
        elif isinstance(op, CompressOp):
            for dev in range(n_dev):
                if op.flag[dev]:
                    w = int(op.width[dev])
                    acc = buf[dev, 0].copy()
                    for j in range(1, w):
                        acc = acc + buf[dev, j]
                    buf[dev, 1:w] = 0
                    buf[dev, 0] = acc
        elif isinstance(op, FoldOp):
            for dev in range(n_dev):
                cnt = int(op.count[dev])
                if cnt > 0:
                    st = int(op.start[dev])
                    acc = buf[dev, st].copy()
                    for j in range(1, cnt):
                        acc = acc + buf[dev, st + j]
                    buf[dev, st] = acc
        else:  # CompactOp
            old = buf.copy()
            for dev in range(n_dev):
                for i, srci in enumerate(op.src[dev]):
                    buf[dev, i] = old[dev, srci] if srci >= 0 else 0
    acc = buf[prog.root_home, 0].copy()
    for j in range(1, prog.root_count):
        acc = acc + buf[prog.root_home, j]
    return acc


def _sweep():
    """(topology, pristine program, degraded program, x) of the JAX
    package's degraded-capacity sweep (same seed, same draws)."""
    rng = np.random.default_rng(1)
    for dims in DIMS:
        topo = T.chip_level_tree(*dims)
        t = topo.tree
        x = rng.standard_normal((topo.n_devices, 3)).astype(np.float32)
        for _ in range(12):
            blue = rng.random(t.n) < 0.5
            ks = rng.choice(t.n, size=int(rng.integers(1, 4)),
                            replace=False)
            scales = {int(s): float(rng.choice(
                [0.9, 0.75, 0.5, 0.25, 0.1, 0.01])) for s in ks}
            yield (T.build_program(topo, blue),
                   T.build_program(T.degrade_switches(topo, scales), blue), x)


def _bytes_equal(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()


def test_executor_equals_host_interpreter_bitwise():
    kinds, n = set(), 0
    for pristine, degraded, x in _sweep():
        ref = _run_host(pristine, x)
        for prog in (pristine, degraded):
            _bytes_equal(T.tree_allreduce(torch.as_tensor(x), prog), ref)
            kinds |= {type(op).__name__ for op in prog.ops}
            n += 1
    assert n == 96
    assert kinds == {"PermuteRound", "CompressOp", "FoldOp", "CompactOp"}


@pytest.mark.parametrize("strategy", ["soar", "top", "max", "random"])
def test_executor_sums_planned_programs(strategy):
    """Every planner's program reduces to the sum; dead devices' inputs
    drop out; a wide odd D."""
    opts = {"options": CPU} if strategy == "soar" else {}
    rng = np.random.default_rng(11)
    base = T.chip_level_tree(2, 2, 4)
    for topo, dead in ((base, []), (T.fail_devices(base, [3, 9]), [3, 9])):
        x = rng.standard_normal((topo.n_devices, 1001)).astype(np.float32)
        x[dead] = 0.0
        for k in (0, 1, 3, topo.tree.n):
            prog = T.plan(topo, k, strategy=strategy, **opts).program
            got = T.tree_allreduce(torch.as_tensor(x), prog)
            _bytes_equal(got, _run_host(prog, x))
            np.testing.assert_allclose(got.numpy(), x.sum(0), rtol=1e-5,
                                       atol=1e-5)


def test_tree_allreduce_tree_and_boundary_checks():
    prog = T.plan(T.chip_level_tree(2, 2, 2), 2, options=CPU).program
    g = torch.Generator().manual_seed(0)
    grads = {"w": torch.randn(8, 3, 4, generator=g),
             "b": [torch.randn(8, generator=g),
                   (torch.randn(8, 5, generator=g),)]}
    out = T.tree_allreduce_tree(grads, prog)
    assert out["w"].shape == (3, 4) and out["b"][0].shape == ()
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
    assert torch.equal(out["w"].reshape(-1), T.tree_allreduce(
        grads["w"].reshape(8, -1), prog))
    assert torch.equal(out["b"][1][0], T.tree_allreduce(grads["b"][1][0],
                                                        prog))
    with pytest.raises(ValueError, match="n_dev"):
        T.tree_allreduce_tree({"w": torch.zeros(7, 2)}, prog)
    with pytest.raises(ValueError, match=r"\(8, D\)"):
        T.tree_allreduce(torch.zeros(4, 3), prog)
    with pytest.raises(TypeError, match="float32"):
        T.tree_allreduce(torch.zeros(8, 3, dtype=torch.float64), prog)


def _folds(prog):
    return sum(isinstance(op, (CompressOp, FoldOp)) for op in prog.ops)


def test_device_program_layout_and_cache():
    """A compiled program is Reduce steps only: one per CompressOp and
    FoldOp, plus the destination's; every partial is written once, by an
    earlier step than any that reads it."""
    topo = T.chip_level_tree(2, 2, 4)
    for pristine, degraded, _ in list(_sweep())[-12:]:
        for prog in (pristine, degraded):
            dp = device_program(prog, "cpu")
            assert device_program(prog, "cpu") is dp
            assert dp.n_reduce == _folds(prog) + 1
            assert len(dp.steps) == _folds(prog)
            assert all(type(st).__name__ == "_Reduce" for st in dp.steps)
            written = []
            for st in dp.steps + (dp.dest,):
                read = st.table[st.table >= 0]
                assert bool((read < prog.n_dev + len(written)).all())
                written += st.out_rows.tolist()
            assert written[:-1] == list(range(dp.n_partials))
    # all devices dead: nothing reaches the root, the sum is zero
    prog = T.build_program(T.fail_devices(topo, range(topo.n_devices)),
                           all_red(topo.tree))
    assert prog.root_home == -1
    assert torch.equal(T.tree_allreduce(torch.ones(16, 2), prog),
                       torch.zeros(2))
    # a round delivering twice to one device is refused
    bad = T.build_program(topo, all_red(topo.tree))
    bad.ops[0].perm = bad.ops[0].perm + bad.ops[0].perm[:1]
    with pytest.raises(ValueError, match="delivers twice"):
        compile_program(bad, "cpu")


def _planned_programs():
    base = T.chip_level_tree(2, 2, 4)
    for strategy in ("soar", "top", "max", "random"):
        opts = {"options": CPU} if strategy == "soar" else {}
        for topo in (base, T.fail_devices(base, [3, 9])):
            for k in (0, 1, 3, topo.tree.n):
                yield T.plan(topo, k, strategy=strategy, **opts).program


def test_programs_materialize_no_delivery():
    """``build_program`` never delivers onto an occupied slot: compiling
    the 96 sweep programs and the planned programs of
    ``test_executor_sums_planned_programs`` adds no Reduce."""
    progs = [p for pristine, degraded, _ in _sweep()
             for p in (pristine, degraded)] + list(_planned_programs())
    assert len(progs) == 96 + 32
    for prog in progs:
        dp = compile_program(prog, "cpu")
        assert dp.merges == 0
        assert dp.n_reduce == _folds(prog) + 1


def test_delivery_onto_occupied_slot_equals_host_bitwise():
    """A hand-built program whose round delivers onto a slot that holds a
    row: the executor folds the two rows in a Reduce of its own (old
    content, then the delivered one) and equals ``_run_host`` bitwise."""
    n = 4
    rounds = [PermuteRound(perm=[(1, 0), (3, 2)], slab=1,
                           recv_offset=np.zeros(n, np.int64),
                           recv_count=np.asarray([1, 0, 1, 0])),
              PermuteRound(perm=[(2, 0)], slab=2,
                           recv_offset=np.asarray([1, 0, 0, 0]),
                           recv_count=np.asarray([2, 0, 0, 0]))]
    prog = T.ReduceProgram(
        n_dev=n, n_slots=3,
        ops=rounds + [CompressOp(flag=np.asarray([True, False, False,
                                                  False]),
                                 width=np.asarray([3, 1, 1, 1]))],
        root_home=0, root_count=1, utilization=0.0,
        total_network_messages=0)
    dp = compile_program(prog, "cpu")
    assert dp.merges == 2
    assert dp.n_reduce == _folds(prog) + 1 + 1
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((n, 257))
         * np.exp(3 * rng.standard_normal((n, 257)))).astype(np.float32)
    _bytes_equal(T.tree_allreduce(torch.as_tensor(x), prog),
                 _run_host(prog, x))


def test_cpu_executor_launches_no_kernel():
    before = segment_reduce_cuda.launches
    T.tree_allreduce(torch.ones(8, 3), T.build_program(
        T.chip_level_tree(2, 2, 2), all_red(T.chip_level_tree(2, 2, 2).tree)))
    assert segment_reduce_cuda.launches == before


# -- against the JAX shard_map executor ---------------------------------------

def _jax_programs():
    """Blue masks and capacity scales of the three cross-checked programs
    of chip_level_tree(2, 2, 2)."""
    topo = T.chip_level_tree(2, 2, 2)
    n = topo.tree.n
    soar = T.plan(topo, 2, options=CPU).blue
    rng = np.random.default_rng(0)
    deg = rng.random(n) < 0.5
    scales = {int(v): 0.5 for v in np.nonzero(deg)[0][:2]}
    return topo, [(soar, {}), (all_red(topo.tree), {}), (deg, scales)]


def _jax_reference(path_in: str, path_out: str) -> None:
    """Subprocess body: the JAX executor on 8 fake CPU devices, on ``x``
    (float32) and on ``xb`` (its float32 values, cast to bfloat16)."""
    import jax
    import jax.numpy as jnp

    import repro.collectives as J
    assert jax.device_count() == 8, jax.device_count()
    data = np.load(path_in)
    mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
    topo = J.chip_level_tree(2, 2, 2)
    outs, outs_bf16 = [], []
    for i, blue in enumerate(data["blues"]):
        ids, fr = data[f"ids{i}"], data[f"fracs{i}"]
        t = J.degrade_switches(topo, dict(zip(ids.tolist(), fr.tolist())))
        prog = J.build_program(t, blue)
        run = jax.jit(lambda v, p=prog: J.tree_allreduce(v, p, mesh, "data"))
        outs.append(np.asarray(run(data["x"])))
        got = run(jnp.asarray(data["xb"], jnp.bfloat16))
        assert got.dtype == jnp.bfloat16
        outs_bf16.append(np.asarray(got).view(np.uint16))
    np.savez(path_out, f32=np.stack(outs), bf16=np.stack(outs_bf16))


@pytest.fixture(scope="module")
def jax_executor():
    """The three programs, the inputs, and the JAX executor's results (one
    subprocess for the module)."""
    topo, progs = _jax_programs()
    rng = np.random.default_rng(12)
    x = rng.standard_normal((8, 33)).astype(np.float32)
    # bfloat16: a wide range of magnitudes, so that where a fold rounds
    # shows in the sum
    xb = (rng.standard_normal((8, 1024))
          * np.exp(2.0 * rng.standard_normal((8, 1024)))).astype(np.float32)
    xb = torch.as_tensor(xb).to(torch.bfloat16)
    programs = [T.build_program(T.degrade_switches(topo, scales), blue)
                for blue, scales in progs]
    with tempfile.TemporaryDirectory() as tmp:
        fin, fout = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        arrays = {"x": x, "xb": xb.to(torch.float32).numpy(),
                  "blues": np.stack([b for b, _ in progs])}
        for i, (_, scales) in enumerate(progs):
            arrays[f"ids{i}"] = np.asarray(list(scales), np.int64)
            arrays[f"fracs{i}"] = np.asarray(list(scales.values()))
        np.savez(fin, **arrays)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        out = subprocess.run(
            [sys.executable, __file__, "--jax-ref", fin, fout],
            capture_output=True, text=True, env=env, timeout=60)
        assert out.returncode == 0, out.stderr[-4000:]
        want = np.load(fout)
        return programs, x, xb, want["f32"], want["bf16"]


def test_executor_equals_jax_shard_map_executor(jax_executor):
    programs, x, _, want, _ = jax_executor
    ported = []
    for prog in programs:
        ported.append(T.tree_allreduce(torch.as_tensor(x), prog))
        _bytes_equal(ported[-1], _run_host(prog, x))
    kinds = {type(op).__name__ for op in programs[-1].ops}
    assert {"FoldOp", "CompactOp"} <= kinds      # the degraded program
    for got, w in zip(ported, want, strict=True):
        assert torch.equal(got, torch.as_tensor(w))
        _bytes_equal(got, w)


def test_bf16_executor_equals_jax_bitwise(jax_executor, monkeypatch):
    """The JAX fold carries a bfloat16 accumulator through its fori_loop:
    it rounds to bfloat16 after every add (a), not once per fold after a
    float32 sum (b). The port's bfloat16 executor does (a) and is bitwise
    equal to the JAX executor; (b) differs on these inputs."""
    programs, _, xb, _, want = jax_executor
    bits = lambda t: t.view(torch.int16).numpy().view(np.uint16)
    for prog, w in zip(programs, want, strict=True):
        got = T.tree_allreduce(xb, prog)
        assert got.dtype == torch.bfloat16 and got.shape == (1024,)
        np.testing.assert_array_equal(bits(got), w)
    ops = importlib.import_module("repro_torch.kernels.segment_reduce.ops")
    each = ops.segment_reduce_torch
    monkeypatch.setattr(ops, "segment_reduce_torch", lambda *a, round_each,
                        **kw: each(*a, round_each=False, **kw))
    differs = [not np.array_equal(bits(T.tree_allreduce(xb, prog)), w)
               for prog, w in zip(programs, want)]
    assert all(differs), differs


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-ref"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    else:
        sys.exit("usage: test_torch_executor.py --jax-ref IN.npz OUT.npy")
