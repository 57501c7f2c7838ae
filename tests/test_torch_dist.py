"""The port's rank executor (``reduce_local`` over ``torch.distributed``) on
gloo CPU ranks vs the single-card executor and the JAX package's
``reduce_local``.

``repro_torch.collectives.reduce_local`` runs one rank per device: each rank
sends the rows that carry content to its peers, one message per round and
pair, folds its own Reduces and, on the root's home, the destination, which
it broadcasts. It is held, bitwise:

* against the single-card ``tree_allreduce`` of the stacked inputs and
  against the JAX ``reduce_local`` inside a ``shard_map`` (8 fake CPU
  devices, ``jax.sharding.Mesh(np.array(jax.devices()), ("data",))``, no
  ``with mesh:``, ROADMAP C3; under ``jax.jit``; one subprocess, this file
  run as ``python tests/test_torch_dist.py --jax-ref IN OUT``), on every
  rank, for ``dp_fleet(8)``'s SOAR programs at k = 0-3, the three
  programs of ``tests/test_torch_executor.py`` (SOAR at k = 2, all red, a
  degraded program with FoldOp and CompactOp rounds) and a program with
  two failed devices; in float32, and in bfloat16 compared as ``uint16``;
  on shaped, flat and 0-d leaves;
* on worlds of 1 and 2 ranks (``dp_fleet(1)``, ``dp_fleet(2)``; JAX on
  meshes of 1 and 2 devices), and on groups of 1 and 2 ranks carved from
  the 8-rank world, so that a rank's device index is its rank in the
  group, not in the world;
* a group whose size is not the program's raises.

The worlds of 8, 2 and 1 ranks are one spawn each for the module (this
file run as ``python tests/test_torch_dist.py --ranks N IN OUT``), all
started together, their groups initialised from a ``file://`` store in a
temporary directory (no port). The rank programs
are also checked without ranks: summed over ranks, their Reduce groups are
the single-card program's, and what they send is the content rows only.
Inputs are standard normal (bfloat16: over a wide range of magnitudes), so
no sum is zero and equal values are equal bytes.
"""
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.collectives as C
from repro_torch.collectives.schedule import PermuteRound
from repro_torch.collectives.tree_allreduce import (_trace,
                                                    compile_rank_program,
                                                    device_program,
                                                    program_fingerprint,
                                                    rank_program)
from repro_torch.core.reduce import all_red
from repro_torch.engine import EngineOptions
from repro_torch.launch.train import dp_fleet

ROOT = Path(__file__).resolve().parents[1]
CPU = EngineOptions(device="cpu")
SHAPES = {"shaped": (5, 7), "flat": (257,), "scalar": ()}
N_WORLD = 8
WORLDS = (N_WORLD, 2, 1)      # the 8-rank world carves groups of 2 and 1


@functools.lru_cache(maxsize=None)
def _specs():
    """name -> (n_dev, blue, {switch: capacity fraction}, dead devices):
    the programs, each rebuilt the same way by every rank and by JAX."""
    topo = dp_fleet(8)
    n = topo.tree.n
    specs = {f"soar-k{k}": (8, C.plan(topo, k, options=CPU).blue, {}, [])
             for k in range(4)}
    # tests/test_torch_executor.py's three programs
    rng = np.random.default_rng(0)
    deg = rng.random(n) < 0.5
    specs["exec-soar-k2"] = specs["soar-k2"]
    specs["exec-all-red"] = (8, all_red(topo.tree), {}, [])
    specs["exec-degraded"] = (8, deg, {int(v): 0.5 for v in
                                       np.nonzero(deg)[0][:2]}, [])
    dead = [3, 5]
    specs["failed-3-5"] = (8, C.plan(C.fail_devices(topo, dead), 2,
                                     options=CPU).blue, {}, dead)
    for m in (1, 2):
        t = dp_fleet(m)
        specs[f"group{m}"] = (m, C.plan(t, min(1, t.tree.n),
                                        options=CPU).blue, {}, [])
    return specs


def _program(spec):
    n, blue, scales, dead = spec
    topo = dp_fleet(n)
    if dead:
        topo = C.fail_devices(topo, dead)
    return C.build_program(C.degrade_switches(topo, scales), blue)


def _inputs():
    """(program name, dtype, shape name) -> (n_dev, *shape) float32 values
    (bfloat16 cases: values already representable in bfloat16)."""
    rng = np.random.default_rng(23)
    out = {}
    for name, spec in _specs().items():
        for dt in ("float32", "bfloat16"):
            for sh, shape in SHAPES.items():
                x = rng.standard_normal((spec[0],) + shape)
                if dt == "bfloat16":
                    x = x * np.exp(2.0 * rng.standard_normal(x.shape))
                    x = torch.as_tensor(x, dtype=torch.float32).to(
                        torch.bfloat16).to(torch.float32).numpy()
                out[f"{name}|{dt}|{sh}"] = x.astype(np.float32)
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


# -- the rank bodies (this file run as a script) ------------------------------

def _rank_body(rank: int, world: int, store: str, fin: str,
               out_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        specs = _specs()
        progs = {k: _program(v) for k, v in specs.items()}
        inputs = dict(np.load(fin))
        # every rank takes part in creating every group
        groups = ({1: dist.new_group([world - 1]),
                   2: dist.new_group([world - 2, world - 1])}
                  if world == N_WORLD else {})
        res = {}
        for key, x in inputs.items():
            name, dt, _ = key.split("|")
            n = specs[name][0]
            if n == world:
                group, me = None, rank
            elif world == N_WORLD and rank >= world - n:
                group, me = groups[n], rank - (world - n)
            else:
                continue
            mine = torch.as_tensor(x[me]).to(getattr(torch, dt))
            got = C.reduce_local(mine, progs[name], group)
            assert got.dtype == mine.dtype and got.shape == mine.shape
            res[key] = _bits(got)
        errors = {}
        if world == N_WORLD and rank >= world - 2:  # 2 ranks, 8's program
            try:
                C.reduce_local(torch.ones(3), progs["soar-k2"], groups[2])
            except ValueError as e:
                errors["size"] = str(e)
        np.savez(os.path.join(out_dir, f"w{world}-rank{rank}.npz"), **res,
                 **{f"error|{k}": np.asarray(v) for k, v in errors.items()})
    finally:
        dist.destroy_process_group()


def _spawn(world: int, fin: str, out_dir: str) -> None:
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_body, args=(world, os.path.join(tmp, "store"), fin,
                                   out_dir), nprocs=world)


# -- the JAX reference (this file run as a script) ----------------------------

def _jax_reference(fin: str, fout: str) -> None:
    """Every device's result of the JAX ``reduce_local`` inside a
    shard_map, for every input of ``fin``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro.collectives as J
    from repro.collectives.tree_allreduce import _shard_map
    from repro.collectives.tree_allreduce import reduce_local as j_reduce
    from repro.launch.train import dp_fleet as j_dp_fleet
    assert jax.device_count() == N_WORLD, jax.device_count()
    data = dict(np.load(fin))
    out = {}
    runs = {}
    for key, x in data.items():
        if not key.startswith("x|"):
            continue
        _, name, dt, sh = key.split("|")
        n = int(data[f"n|{name}"])
        if name not in runs:
            topo = j_dp_fleet(n)
            dead = data[f"dead|{name}"].tolist()
            if dead:
                topo = J.fail_devices(topo, dead)
            scales = dict(zip(data[f"ids|{name}"].tolist(),
                              data[f"fracs|{name}"].tolist()))
            prog = J.build_program(J.degrade_switches(topo, scales),
                                   data[f"blue|{name}"])
            mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
            body = (lambda xb, p=prog: j_reduce(xb[0], p, "data")[None])
            runs[name] = jax.jit(_shard_map(body, mesh=mesh,
                                            in_specs=P("data"),
                                            out_specs=P("data")))
        got = runs[name](jnp.asarray(x, getattr(jnp, dt)))
        got = np.asarray(got)
        out[f"{name}|{dt}|{sh}"] = (got.view(np.uint16) if dt == "bfloat16"
                                    else got.view(np.uint32))
    np.savez(fout, **out)


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """The inputs, the ranks' results (one spawn of 8 gloo CPU ranks) and
    the JAX results (one subprocess), both started together."""
    inputs = _inputs()
    specs = _specs()
    with tempfile.TemporaryDirectory() as tmp:
        fin = os.path.join(tmp, "in.npz")
        np.savez(fin, **inputs)
        jin, jout = os.path.join(tmp, "jax_in.npz"), os.path.join(
            tmp, "jax_out.npz")
        arrays = {f"x|{k}": v for k, v in inputs.items()}
        for name, (n, blue, scales, dead) in specs.items():
            arrays[f"n|{name}"] = np.asarray(n)
            arrays[f"blue|{name}"] = np.asarray(blue, bool)
            arrays[f"ids|{name}"] = np.asarray(list(scales), np.int64)
            arrays[f"fracs|{name}"] = np.asarray(list(scales.values()),
                                                 np.float64)
            arrays[f"dead|{name}"] = np.asarray(dead, np.int64)
        np.savez(jin, **arrays)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{N_WORLD}")
        jax_p = subprocess.Popen(
            [sys.executable, __file__, "--jax-ref", jin, jout],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        worlds = {w: subprocess.Popen(
            [sys.executable, __file__, "--ranks", str(w), fin, tmp],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for w in WORLDS}
        for w, proc in worlds.items():
            _, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, (w, err[-4000:])
        _, jerr = jax_p.communicate(timeout=240)
        assert jax_p.returncode == 0, jerr[-4000:]
        got = {w: [dict(np.load(os.path.join(tmp, f"w{w}-rank{r}.npz")))
                   for r in range(w)] for w in WORLDS}
        want = dict(np.load(jout))
    return inputs, got, want


def _single_card(key, x):
    name, dt, _ = key.split("|")
    prog = _program(_specs()[name])
    stack = torch.as_tensor(x).to(getattr(torch, dt))
    return _bits(C.tree_allreduce(stack.reshape(len(x), -1), prog).reshape(
        x.shape[1:]))


def _ranks_of(key):
    """(world, rank) of every rank that reduced ``key``'s input, in device
    order: the 8-rank world's own ranks or its carved group's, and a world
    of the program's size."""
    n = _specs()[key.split("|")[0]][0]
    if n == N_WORLD:
        return [[(N_WORLD, r) for r in range(N_WORLD)]]
    return [[(N_WORLD, r) for r in range(N_WORLD - n, N_WORLD)],
            [(n, r) for r in range(n)]]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(_specs()))
def test_reduce_local_equals_single_card_and_jax(runs, name, dt):
    inputs, got, want = runs
    for sh in SHAPES:
        key = f"{name}|{dt}|{sh}"
        ref = _single_card(key, inputs[key])
        jax_rows = want[key]
        for ranks in _ranks_of(key):
            for i, (w, r) in enumerate(ranks):
                mine = got[w][r][key]
                assert mine.shape == ref.shape, (key, w, r)
                np.testing.assert_array_equal(
                    mine, ref, err_msg=f"{key} world {w} rank {r}")
                np.testing.assert_array_equal(
                    jax_rows[i], ref, err_msg=f"{key} JAX device {i}")


def test_every_program_kind_is_covered():
    kinds = {type(op).__name__ for spec in _specs().values()
             for op in _program(spec).ops}
    assert kinds == {"PermuteRound", "CompressOp", "FoldOp", "CompactOp"}
    failed = _program(_specs()["failed-3-5"])
    assert failed.root_home >= 0 and failed.total_network_messages > 0


def test_group_of_the_wrong_size_raises(runs):
    _, got, _ = runs
    for r in (N_WORLD - 2, N_WORLD - 1):
        msg = str(got[N_WORLD][r]["error|size"])
        assert "the group has 2 ranks" in msg and "8 devices" in msg


# -- the rank programs, without ranks -----------------------------------------

def _groups_read(tables):
    return sum(int((t.table >= 0).sum()) for t in tables)


@pytest.mark.parametrize("name", list(_specs()))
def test_rank_programs_sum_to_the_single_card_program(name):
    """Summed over ranks, the Reduce groups and the rows they read are the
    single-card program's, and a rank launches once for each Reduce step
    that folds on its device; what the ranks send is received once, in no
    more rows than the JAX executor's slabs."""
    prog = _program(_specs()[name])
    dp = device_program(prog, "cpu")
    rps = [compile_rank_program(prog, r, "cpu") for r in range(prog.n_dev)]
    events, _, _ = _trace(prog)
    per_device = sum(len({dev for dev, *_ in ev}) for kind, ev in events
                     if kind == "reduce")
    assert (sum(rp.n_reduce for rp in rps)
            == per_device + (prog.root_home >= 0))
    reduces = lambda rp: [st for st in rp.steps if not hasattr(st, "sends")]
    assert (sum(len(st.out_rows) for rp in rps for st in reduces(rp))
            == sum(len(st.out_rows) for st in dp.steps))
    assert (sum(_groups_read(reduces(rp)) for rp in rps)
            == _groups_read(dp.steps))
    assert sum(rp.dest is not None for rp in rps) == (prog.root_home >= 0)
    if prog.root_home >= 0:
        assert (_groups_read([rps[prog.root_home].dest])
                == _groups_read([dp.dest]))
    sent = sum(rp.rows_sent for rp in rps)
    assert sent == sum(rp.rows_received for rp in rps)
    slabs = sum(op.slab * len(op.perm) for op in prog.ops
                if isinstance(op, PermuteRound))
    assert sent <= slabs
    assert all(rank_program(prog, r, "cpu") is rank_program(prog, r, "cpu")
               for r in range(prog.n_dev))


def test_rank_program_sends_only_content_rows():
    """With two failed devices the JAX slabs carry rows that no one reads;
    the ranks send strictly fewer rows. Every program's ranks send one
    message per round and pair, none empty."""
    slabs = lambda prog: sum(op.slab * len(op.perm) for op in prog.ops
                             if isinstance(op, PermuteRound))
    prog = _program(_specs()["failed-3-5"])
    rps = [compile_rank_program(prog, r, "cpu") for r in range(8)]
    assert sum(rp.rows_sent for rp in rps) < slabs(prog)
    for spec in _specs().values():
        prog = _program(spec)
        for r in range(prog.n_dev):
            for st in compile_rank_program(prog, r, "cpu").steps:
                if hasattr(st, "sends"):
                    peers = [p for p, *_ in st.sends]
                    assert len(peers) == len(set(peers))
                    assert all(len(rows) > 0 for _, rows, _ in st.sends)


def test_rank_program_refuses_a_self_pair_and_a_bad_rank():
    prog = _program(_specs()["exec-all-red"])
    with pytest.raises(ValueError, match="outside"):
        compile_rank_program(prog, 8, "cpu")
    op = next(o for o in prog.ops if isinstance(o, PermuteRound))
    s, _ = op.perm[0]
    op.perm = [(s, s)] + op.perm[1:]
    with pytest.raises(ValueError, match="to itself"):
        compile_rank_program(prog, 0, "cpu")


def test_program_fingerprint_tells_programs_apart():
    specs = _specs()
    same = {"exec-soar-k2": "soar-k2", "exec-all-red": "soar-k0"}
    prints = {name: program_fingerprint(_program(s))
              for name, s in specs.items() if name not in same}
    assert len(set(prints.values())) == len(prints)
    for a, b in same.items():       # k = 0 is all red; the same program
        assert program_fingerprint(_program(specs[a])) == prints[b]
    assert all(0 <= v < 2 ** 63 for v in prints.values())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--jax-ref"]:
        _jax_reference(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ranks"]:
        _spawn(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit("usage: test_torch_dist.py --jax-ref IN OUT | --ranks N IN "
                 "OUT_DIR")
