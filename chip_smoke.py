#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of SOAR on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs a card

Drives the port's two paths at full size on the card: the batched
placement solve (``repro_torch.engine.solve_batch``) and the reduce path
(``repro_torch.collectives``: ``plan`` -> ``build_program`` ->
``tree_allreduce``). It builds the CUDA kernels from
``src/repro_torch/csrc`` and holds every kernel against its plain torch
version on the inputs the paths give it. Phases:

1. device: name, power limit, versions, kernel build time;
2. kernels vs plain versions on the card, bitwise (``torch.equal``):
   min-plus on random rows with BIG entries, then both kernels on every
   level of both configurations below, float32 and float64, with times;
3. main path ``bt4096-x64-k64``: 64 tenants on BT(4096) (paper Sec. 5,
   Figs. 9-10), exponential (dyadic) rates, power-law loads, k = 64; the
   card's masks and costs must equal the CPU path bitwise and the serial
   ``soar`` on 4 instances, and each kernel must have run;
4. ragged path ``rpa1024-x16-k16``: 16 scale-free rpa(1024) trees (paper
   Appendix B, Fig. 11) with 80% availability, k = 16, max_children 128;
   the same checks plus ``rho_scale`` / ``rho_root_add`` re-solves;
5. segment-reduce kernel vs its plain version on the card, bitwise, on
   random (G, C, D) in float32 and bfloat16 and on every launch the
   executor makes in phase 6;
6. reduce path: ``plan`` on the card, ``build_program``, ``tree_allreduce``
   on the card at ``chip64-k16-d6.5m`` (64 devices, one 25 MiB gradient
   bucket each), ``chip256-k16-d256k``, a degraded 256-device program with
   FoldOp and CompactOp rounds, and all-red ``chip64-k0-d64k``; each result
   must equal the plain executor on the card and the CPU executor bitwise,
   stay within the float32 error bound of the exact sum, and run one
   kernel launch per Reduce op plus one.

Any failed check raises and exits nonzero. Only when every phase passed
does it print the kernels JSON line, the card's name and power limit, and
last the JSON line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


class CheckFailed(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Recorder:
    """Records the engine's level-fold and chain calls during one solve.

    Swaps the names ``level_fold`` and ``chain_fold`` in the engine module
    for wrappers that keep their arguments and call through, so the inputs
    are exactly those of the main path.
    """

    def __init__(self, batched):
        self.batched = batched
        self.folds: list = []
        self.chains: list = []

    def __enter__(self):
        b = self.batched
        self._orig = (b.level_fold, b.chain_fold)
        fold, chain = self._orig

        def rec_fold(*args, **kw):
            self.folds.append((args, kw))
            return fold(*args, **kw)

        def rec_chain(st, collect=False):
            self.chains.append(st)
            return chain(st, collect)

        b.level_fold, b.chain_fold = rec_fold, rec_chain
        return self

    def __exit__(self, *exc):
        self.batched.level_fold, self.batched.chain_fold = self._orig


def fold_work(args, kw) -> tuple[int, int]:
    """(bytes, operations) one level fold needs: each operand read once
    and the output written once; two operations (add, min) per min-plus
    candidate, K*K candidates per row for every real child after the
    first, plus the epilogue's five per output entry of a real node."""
    xs, kid = args[0], args[2]
    nl, kcap = kw["nl"], kw["kcap"]
    B, W = kid.shape[:2]
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += B * W * nl * kcap * xs.element_size()
    real = (kid != xs.shape[1] - 1).sum(dim=2)
    folds = int((real - 1).clamp(min=0).sum())
    nodes = int((real > 0).sum())
    return nbytes, 2 * folds * (nl + 1) * kcap * kcap + 5 * nodes * nl * kcap


def chain_pairs(chains, f):
    """The min-plus launches of the color's chains: (acc, child, real
    rows) per launch, the accumulators replayed with the plain version.
    A row is real where its node's child m exists; the recorded chains
    come top-down, one per level with internal nodes."""
    import torch

    from repro_torch.kernels.minplus.levelfold import minplus_fused
    levels = [d for d in range(f.h_max + 1)
              if f.lvl_width[d] and f.lvl_internal[d]]
    check(len(levels) == len(chains), "one recorded chain per level")
    pairs = []
    for d, st in zip(levels, chains):
        o, wi = f.lvl_off[d], f.lvl_internal[d]
        kid = torch.as_tensor(f.pk_kid[:, o : o + wi])
        acc = st[0]
        for m in range(1, st.shape[0]):
            real_rows = 2 * int((kid[:, :, m] < f.n_slots).sum())
            pairs.append((acc, st[m], real_rows))
            acc = minplus_fused(acc, st[m])
    return pairs


def compare_kernels(f, k, dtype, label):
    """Record one solve's kernel inputs on the card; hold both kernels
    against their plain versions on every one of them, bitwise."""
    import torch

    from repro_torch.engine import EngineOptions, batched, solve_forest
    from repro_torch.kernels.minplus.levelfold import (level_fold_cuda,
                                                       level_fold_torch,
                                                       minplus_fused)
    from repro_torch.kernels.minplus.minplus import minplus_cuda
    with Recorder(batched) as rec:
        solve_forest(f, k, options=EngineOptions(dtype=dtype))
    err = 0.0
    for args, kw in rec.folds:
        args = tuple(t.contiguous() for t in args)
        got, want = level_fold_cuda(*args, **kw), level_fold_torch(*args, **kw)
        err = max(err, float((got.double() - want.double()).abs().max()))
        check(torch.equal(got, want),
              f"{label}: level fold != plain at nl={kw['nl']}")
    pairs = chain_pairs(rec.chains, f)
    mp_err = 0.0
    for a, b, _ in pairs:
        got, want = minplus_cuda(a, b), minplus_fused(a, b)
        mp_err = max(mp_err, float((got.double() - want.double()).abs().max()))
        check(torch.equal(got, want), f"{label}: min-plus != plain")
    say(f"kernels {label} {str(dtype)[6:]}: level fold bitwise on "
        f"{len(rec.folds)} levels, min-plus bitwise on {len(pairs)} "
        f"launches")
    return rec.folds, pairs, err, mp_err


def time_kernels(folds, pairs):
    """Per-solve device time of each kernel and of its plain version over
    the recorded calls, with the bound from this run's shapes."""
    from repro_torch.kernels.minplus.levelfold import (level_fold_cuda,
                                                       level_fold_torch,
                                                       minplus_fused)
    from repro_torch.kernels.minplus.minplus import minplus_cuda
    folds = [(tuple(t.contiguous() for t in a), kw) for a, kw in folds]
    out = {}
    fb = fo = 0
    for a, kw in folds:
        nb, no = fold_work(a, kw)
        fb, fo = fb + nb, fo + no
    out["levelfold"] = dict(
        ms=cuda_ms(lambda: [level_fold_cuda(*a, **kw) for a, kw in folds], 20),
        plain_ms=cuda_ms(lambda: [level_fold_torch(*a, **kw)
                                  for a, kw in folds], 3, warmup=1),
        nbytes=fb, ops=fo,
        # (depth, K, ms, bound ms) of each level's launch
        levels=[(kw["nl"] - 2, kw["kcap"],
                 cuda_ms(lambda a=a, kw=kw: level_fold_cuda(*a, **kw), 20),
                 max(nb / HBM_BYTES_PER_S, no / FP32_OPS_PER_S) * 1e3)
                for a, kw in folds for nb, no in [fold_work(a, kw)]])
    mb = sum(3 * a.numel() * a.element_size() for a, _, _ in pairs)
    mo = sum(2 * r * a.shape[1] ** 2 for a, _, r in pairs)
    out["minplus"] = dict(
        ms=cuda_ms(lambda: [minplus_cuda(a, b) for a, b, _ in pairs], 20),
        plain_ms=cuda_ms(lambda: [minplus_fused(a, b) for a, b, _ in pairs],
                         3, warmup=1),
        nbytes=mb, ops=mo)
    for v in out.values():
        t_bytes = v["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = v["ops"] / FP32_OPS_PER_S * 1e3
        v["bound_ms"] = max(t_bytes, t_ops)
        v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def expected_launches(f) -> tuple[int, int]:
    """Level-fold and min-plus launches one solve of ``f`` makes."""
    levels = [d for d in range(f.h_max + 1)
              if f.lvl_width[d] and f.lvl_internal[d]]
    return len(levels), len(levels) * (f.max_children - 1)


def _counted():
    from repro_torch.kernels.minplus.levelfold import level_fold_cuda
    from repro_torch.kernels.minplus.minplus import minplus_cuda
    from repro_torch.kernels.segment_reduce.segment_reduce import (
        segment_reduce_cuda)
    return level_fold_cuda, minplus_cuda, segment_reduce_cuda


def reset_counts():
    for fn in _counted():
        fn.launches = 0


def read_counts() -> tuple[int, int, int]:
    """Launches of the level fold, min-plus and segment reduce."""
    return tuple(fn.launches for fn in _counted())


def check_against(res, ref, label):
    check(res.blue is not None and ref.blue is not None, f"{label}: masks")
    check(res.blue.shape == ref.blue.shape, f"{label}: mask shape")
    check((res.blue == ref.blue).all(), f"{label}: masks differ from CPU")
    check((res.costs == ref.costs).all(), f"{label}: costs differ from CPU")


def check_serial(res, trees, loads, avail, k, sample, label):
    import numpy as np

    from repro_torch.core import phi, soar
    for b in sample:
        av = None if avail is None else avail[b]
        t0 = time.perf_counter()
        ref = soar(trees[b], loads[b], k, avail=av)
        secs = time.perf_counter() - t0
        blue = res.blue_of(b)
        check(np.isfinite(res.costs[b]), f"{label}: cost {b} not finite")
        check(res.costs[b] == ref.cost,
              f"{label}: cost {b} {res.costs[b]} != serial {ref.cost}")
        check(phi(trees[b], loads[b], blue) == res.costs[b],
              f"{label}: phi(mask {b}) != cost")
        check(np.array_equal(blue, ref.blue), f"{label}: mask {b} != serial")
        check(blue.sum() <= k, f"{label}: mask {b} over budget")
        check(av is None or not (blue & ~av).any(),
              f"{label}: mask {b} uses an unavailable switch")
    say(f"{label}: serial soar agrees on instances {list(sample)} "
        f"(last took {secs:.2f} s on the host)")


def solve_timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run_config(name, trees, loads, avail, k, sample, overrides=False):
    """Phases 3 and 4: the entry point on the card, held against the CPU
    path, the serial oracle and the launch counts."""
    import numpy as np
    import torch

    from repro_torch.core import build_forest
    from repro_torch.engine import (EngineOptions, batched, solve_batch,
                                    solve_forest)
    cpu = EngineOptions(device="cpu")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, first_s = solve_timed(lambda: solve_batch(trees, loads, k, avail))
    launches, reduces = read_counts()[:2], read_counts()[2]
    f = build_forest(trees, loads, avail)
    want = expected_launches(f)
    check(launches == want, f"{name}: launches {launches} != {want}")
    check(all(n > 0 for n in launches), f"{name}: a kernel did not run")
    check(reduces == 0, f"{name}: the solve launched a segment reduce")
    peak = torch.cuda.max_memory_allocated()
    check(res.costs.shape == (len(trees),) and np.isfinite(res.costs).all(),
          f"{name}: costs shape or finiteness")
    ref = solve_batch(trees, loads, k, avail, options=cpu)
    check_against(res, ref, name)
    check_serial(res, trees, loads, avail, k, sample, name)
    warm = [solve_timed(lambda: solve_forest(f, k))[1] for _ in range(5)]
    # layer breakdown of one warm solve: upload (cached after the first
    # solve of a Forest, so a fresh Forest pays it), gather, color+copy
    g = build_forest(trees, loads, avail)
    pack_s = solve_timed(lambda: build_forest(trees, loads, avail))[1]
    dev = torch.device("cuda")
    inputs, up_s = solve_timed(lambda: batched._device_inputs(
        g, torch.float32, dev))
    blocks, gather_s = solve_timed(lambda: batched._gather_device(
        g, k, True, inputs))
    _, color_s = solve_timed(lambda: [t.cpu() for t in batched._color_packed(
        blocks, inputs[0], inputs[5], inputs[6], inputs[1], inputs[2],
        inputs[3], inputs[4], inputs[8], inputs[7], lvl_off=g.lvl_off,
        lvl_width=g.lvl_width, lvl_internal=g.lvl_internal,
        lvl_sub=g.lvl_sub, k=k, cap=True)])
    say(f"{name}: B={len(trees)} n_slots={f.n_slots} h_max={f.h_max} "
        f"max_children={f.max_children} k={k}")
    say(f"{name}: card == CPU bitwise (masks, costs); launches level fold "
        f"{launches[0]}, min-plus {launches[1]}; first solve_batch "
        f"{first_s:.4f} s; warm solve_forest min {min(warm):.6f} s median "
        f"{statistics.median(warm):.6f} s; bytes_to_host "
        f"{res.bytes_to_host}; max_memory_allocated {peak}")
    say(f"{name}: layers of one solve: pack {pack_s:.6f} s, upload "
        f"{up_s:.6f} s, gather {gather_s:.6f} s, color+copy "
        f"{color_s:.6f} s")
    f64 = solve_forest(f, k, options=EngineOptions(dtype=torch.float64))
    check_serial(f64, trees, loads, avail, k, sample[:2], name + " f64")
    if overrides:
        rng = np.random.default_rng(7)
        scale = rng.integers(1, 9, size=(f.batch, f.n_max)) / 4.0
        extra = rng.integers(0, 17, size=f.batch) / 8.0
        for kw in ({"rho_scale": scale},
                   {"rho_scale": scale, "rho_root_add": extra}):
            check_against(solve_forest(f, k, **kw),
                          solve_forest(f, k, options=cpu, **kw),
                          f"{name} {'+'.join(kw)}")
        say(f"{name}: rho_scale and rho_scale+rho_root_add re-solves == "
            f"CPU bitwise")
    return f, launches


def check_minplus_random():
    import numpy as np
    import torch

    from repro_torch.core.tropical import BIG
    from repro_torch.kernels.minplus.levelfold import minplus_fused
    from repro_torch.kernels.minplus.ops import minplus
    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.float64):
        for K in (2, 17, 65, 129):
            a, b = (rng.integers(0, 4000, size=(1000, K)) / 8.0
                    for _ in range(2))
            a[rng.random(a.shape) < 0.2] = BIG
            b[rng.random(b.shape) < 0.2] = BIG
            ta = torch.as_tensor(a, dtype=dt, device="cuda")
            tb = torch.as_tensor(b, dtype=dt, device="cuda")
            check(torch.equal(minplus(ta, tb), minplus_fused(ta, tb)),
                  f"min-plus != plain at K={K} {dt}")
    say("kernels: min-plus bitwise on (1000, K) rows, K in {2, 17, 65, "
        "129}, float32 and float64, with BIG entries")


# -- phases 5 and 6: the reduce path -----------------------------------------

REDUCE_SHAPES = [(1, 1, 8), (4, 7, 130), (16, 32, 512), (3, 5, 1000),
                 (64, 8, 1_000_003)]


def check_segment_reduce_random() -> float:
    """Phase 5, random inputs: the kernel bitwise equal to its plain
    version at every shape, float32 and bfloat16, masks of density 0.7.
    Returns the largest absolute difference seen."""
    import numpy as np
    import torch

    from repro_torch.kernels.segment_reduce.ops import segment_reduce
    from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
    err = 0.0
    gen = torch.Generator(device="cuda").manual_seed(5)
    for g, c, d in REDUCE_SHAPES:
        mask = torch.as_tensor(
            np.random.default_rng(g * 100 + c).random((g, c)) < 0.7,
            device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((g, c, d), generator=gen, device="cuda").to(dt)
            got, want = segment_reduce(x, mask), segment_reduce_torch(x, mask)
            err = max(err, float((got.double() - want.double()).abs().max()))
            check(torch.equal(got, want),
                  f"segment reduce != plain at {(g, c, d)} {dt}")
            del x, got, want
    say("kernels: segment reduce bitwise on random (G, C, D) in "
        f"{REDUCE_SHAPES}, float32 and bfloat16, mask density 0.7")
    return err


class LaunchCheck:
    """Phase 5 on the executor's launches: swaps the executor's
    ``reduce_rows`` for one that computes the plain version on the launch's
    inputs, launches the kernel as the executor does, and requires the two
    bitwise equal. Keeps (buffer, mask, rows) of every launch for timing."""

    def __init__(self, mod):
        self.mod = mod
        self.launches: list = []
        self.err = 0.0

    def __enter__(self):
        from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
        self._orig = run = self.mod.reduce_rows

        def checked(flat, mask, rows, *, inplace=False):
            import torch
            want = segment_reduce_torch(flat, mask, rows)
            out = run(flat, mask, rows, inplace=inplace)
            got = flat.index_select(0, rows) if inplace else out
            self.err = max(self.err, float(
                (got.double() - want.double()).abs().max()))
            check(torch.equal(got, want),
                  f"executor launch {len(self.launches)}: kernel != plain")
            self.launches.append((flat, mask, rows))
            return out

        self.mod.reduce_rows = checked
        return self

    def __exit__(self, *exc):
        self.mod.reduce_rows = self._orig


class PlainReduce:
    """The executor with every Reduce on the plain version (on the card)."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        from repro_torch.kernels.segment_reduce.ref import reduce_rows_torch
        self._orig = self.mod.reduce_rows
        self.mod.reduce_rows = reduce_rows_torch
        return self

    def __exit__(self, *exc):
        self.mod.reduce_rows = self._orig


def time_reduce_launches(launches):
    """Per executor call: the kernel, its plain version and torch.einsum on
    the recorded launches, with the bytes bound of this run's masks."""
    import torch

    from repro_torch.kernels.segment_reduce.ref import segment_reduce_torch
    from repro_torch.kernels.segment_reduce.segment_reduce import (
        segment_reduce_cuda)
    nbytes = ops = 0
    stacked = []
    for flat, mask, rows in launches:
        g, c = mask.shape
        d, item = flat.shape[1], flat.element_size()
        nnz = int((mask != 0).sum())
        nbytes += (nnz + g) * d * item
        ops += 2 * nnz * d
        idx = (rows[:, None] + torch.arange(c, device=rows.device)).clamp(
            max=flat.shape[0] - 1)
        stacked.append((flat[idx], mask))     # (G, C, D) for the library
    v = dict(
        ms=cuda_ms(lambda: [segment_reduce_cuda(f, m, r)
                            for f, m, r in launches], 10),
        plain_ms=cuda_ms(lambda: [segment_reduce_torch(f, m, r)
                                  for f, m, r in launches], 3, warmup=1),
        library_ms=cuda_ms(lambda: [torch.einsum("gcd,gc->gd", x3, m)
                                    for x3, m in stacked], 10))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    v["bound_ms"] = max(t_bytes, t_ops)
    v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return v


def n_reduce_ops(prog) -> int:
    from repro_torch.collectives.schedule import CompressOp, FoldOp
    return sum(isinstance(op, (CompressOp, FoldOp)) for op in prog.ops)


# operators whose device time the profiler reports once; it counts the
# buffer's zero-fill (aten::fill_) twice, so that one is read from the
# kernel list (FillFunc)
PROFILED_OPS = ("aten::copy_", "aten::index_select", "aten::index_add_",
                "aten::index_fill_", "aten::index_copy_")


def profile_executor(name, x, prog) -> None:
    """Device time by operator and the device's busy share over one warm
    executor call, from ``torch.profiler``. A measurement, not a check:
    where the profiler records no device time it says "not measured"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.collectives import tree_allreduce
    tree_allreduce(x, prog)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tree_allreduce(x, prog)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = prof.key_averages()
        kernels = [e for e in ev if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        ops = {e.key: (e.device_time_total / 1e3, e.count) for e in ev
               if e.key in PROFILED_OPS}
    except Exception as e:      # the profiler is a guest here: report it
        say(f"{name}: profile not measured ({type(e).__name__}: {e})")
        return
    if busy <= 0:
        say(f"{name}: profile not measured (no device time recorded)")
        return
    say(f"{name}: profile of one executor call: wall {wall * 1e3:.4f} ms "
        f"under the profiler, device busy {busy:.4f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%); device ms (calls) by op: "
        + ", ".join(f"{k} {ops[k][0]:.4f} ({ops[k][1]})"
                    for k in PROFILED_OPS if k in ops))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    say(f"{name}: kernels by device ms: " + "; ".join(
        f"{e.key[:70]} {e.self_device_time_total / 1e3:.4f} ({e.count})"
        for e in top))


def run_reduce(name, topo, d, x, *, k=None, blue=None, pristine=None):
    """Phase 6 for one configuration: ``plan`` on the card (or, with
    ``blue``, only ``build_program``), ``tree_allreduce`` on the card, the
    checks, then the phase-5 launch checks and the timings."""
    import numpy as np
    import torch

    from repro_torch.collectives import build_program, plan, tree_allreduce
    # the module (the package's name tree_allreduce is the function)
    exe = importlib.import_module("repro_torch.collectives.tree_allreduce")
    from repro_torch.core.reduce import phi, phi_degraded
    from repro_torch.engine import solve_batch
    dev = x.device
    # the main path, counted: plan (solve + build_program), executor
    reset_counts()
    if blue is None:
        tp, plan_s = solve_timed(lambda: plan(topo, k))
        blue, prog = tp.blue, tp.program
    else:
        prog, plan_s = solve_timed(lambda: build_program(topo, blue))
    got, first_s = solve_timed(lambda: tree_allreduce(x, prog))
    counts = read_counts()
    want_n = n_reduce_ops(prog) + 1
    check(counts[2] == want_n,
          f"{name}: {counts[2]} segment-reduce launches != {want_n}")
    if k is not None:
        check(counts[0] > 0 and counts[1] > 0,
              f"{name}: plan ran no level fold or min-plus on the card")
    check(got.shape == (d,) and got.dtype == torch.float32
          and bool(torch.isfinite(got).all()), f"{name}: result shape/finite")
    # layers: the solve and build_program apart, the device program's upload
    t = topo.tree
    solve_s = build_s = float("nan")
    if k is not None:
        _, solve_s = solve_timed(lambda: solve_batch(
            [t], [topo.load], k, [topo.candidates()]))
    _, build_s = solve_timed(lambda: build_program(topo, blue))
    fresh = build_program(topo, blue)
    _, upload_s = solve_timed(lambda: exe.device_program(fresh, dev))
    exec_ms = cuda_ms(lambda: tree_allreduce(x, prog), 5, warmup=1)
    profile_executor(name, x, prog)
    # checks against the plain executor, the CPU executor, the exact sum
    with PlainReduce(exe):
        plain = tree_allreduce(x, prog)
        plain_exec_ms = cuda_ms(lambda: tree_allreduce(x, prog), 2, warmup=0)
    check(torch.equal(got, plain), f"{name}: card != plain executor")
    del plain
    cols = min(d, 8192)
    cpu = tree_allreduce(x[:, :cols].cpu(), prog)
    check(torch.equal(cpu, got[:cols].cpu()),
          f"{name}: CPU executor != card on the first {cols} columns")
    exact = x.double().sum(0)
    bound = prog.n_dev * 2.0 ** -23 * x.double().abs().sum(0)
    err = (got.double() - exact).abs()
    check(bool((err <= bound).all()), f"{name}: error over n_dev*eps*sum|x|")
    max_err = float(err.max())
    del exact, bound, err
    util = (phi(t, topo.load, blue) if topo.cap_scale is None
            else phi_degraded(t, topo.load, blue, topo.cap_scale))
    check(prog.utilization == util, f"{name}: utilization != phi")
    if pristine is not None:
        kinds = {type(op).__name__ for op in prog.ops}
        check({"FoldOp", "CompactOp"} <= kinds,
              f"{name}: no FoldOp/CompactOp rounds ({sorted(kinds)})")
        check(torch.equal(got, pristine), f"{name}: != pristine bitwise")
    # phase 5 on this configuration's launches, then their timings
    with LaunchCheck(exe) as lc:
        again = tree_allreduce(x, prog)
    check(torch.equal(again, got), f"{name}: checked run != first run")
    check(len(lc.launches) == want_n, f"{name}: recorded launches")
    times = time_reduce_launches(lc.launches)
    times["max_abs_err"] = lc.err
    del lc, again
    torch.cuda.empty_cache()
    say(f"{name}: n_dev={prog.n_dev} n_slots={prog.n_slots} D={d} "
        f"blue={int(np.sum(blue))} ops={len(prog.ops)} "
        f"(reduce ops {want_n - 1}); launches level fold {counts[0]}, "
        f"min-plus {counts[1]}, segment reduce {counts[2]}; card == plain "
        f"executor == CPU executor ({cols} columns) bitwise; max |err| "
        f"{max_err:.3e} within n_dev*2^-23*sum|x|; utilization "
        f"{prog.utilization}"
        + ("; == pristine bitwise" if pristine is not None else ""))
    say(f"{name}: plan {plan_s:.6f} s (solve {solve_s:.6f} s, "
        f"build_program {build_s:.6f} s); upload {upload_s:.6f} s; first "
        f"executor call {first_s:.6f} s; executor {exec_ms:.4f} ms "
        f"(plain executor {plain_exec_ms:.4f} ms)")
    say(f"{name}: segment reduce {times['ms']:.4f} ms per executor call "
        f"({want_n} launches), bound {times['bound_ms']:.4f} ms "
        f"({times['bound_by']}), plain {times['plain_ms']:.4f} ms, "
        f"torch.einsum {times['library_ms']:.4f} ms")
    return prog, blue, got, counts, times


def reduce_path(d64=6_553_600, d256=262_144, d_red=65_536):
    """Phase 6 over the four configurations (widths D as named); returns
    the main one's segment-reduce launches and timings."""
    import numpy as np
    import torch

    from repro_torch.collectives import chip_level_tree, degrade_switches

    def normal(n_dev, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn((n_dev, d), generator=g, device="cuda")

    t64 = chip_level_tree(2, 4, 8)
    _, _, _, counts, main = run_reduce(
        "chip64-k16-d6.5m", t64, d64, normal(64, d64, 64), k=16)
    torch.cuda.empty_cache()
    t256 = chip_level_tree(4, 8, 8)
    x = normal(256, d256, 256)
    _, blue, pristine, _, _ = run_reduce("chip256-k16-d256k", t256, d256,
                                         x, k=16)
    # degrade the first blue pod and the first blue rack to half capacity
    t = t256.tree
    picks = [int(next(v for v in np.nonzero(blue)[0] if t.depth[v] == dep))
             for dep in (1, 2)]
    run_reduce("chip256-k16-d256k-degraded",
               degrade_switches(t256, {v: 0.5 for v in picks}), d256, x,
               blue=blue, pristine=pristine)
    del x, pristine
    torch.cuda.empty_cache()
    run_reduce("chip64-k0-d64k", t64, d_red, normal(64, d_red, 640), k=0)
    return counts[2], main


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import build_forest, bt, rpa, sample_load
    from repro_torch.kernels import _build

    # phase 1: device
    smi = nvidia_smi_line()
    _build.library()
    say(f"device: {smi}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; kernels built and loaded in "
        f"{_build.build_seconds:.2f} s")

    # the two configurations
    t = bt(4096, "exponential")
    bt_trees = [t] * 64
    bt_loads = [sample_load(t, "power-law", seed=s) for s in range(64)]
    bt_f = build_forest(bt_trees, bt_loads)
    rp_trees = [rpa(1024, seed=s) for s in range(16)]
    rp_loads = [sample_load(tr, "power-law", seed=s)
                for s, tr in enumerate(rp_trees)]
    rng = np.random.default_rng(0)
    rp_avail = [rng.random(tr.n) < 0.8 for tr in rp_trees]
    rp_f = build_forest(rp_trees, rp_loads, rp_avail)

    # phase 2: kernels vs plain versions on the card
    check_minplus_random()
    folds, pairs, lf_err, mp_err = compare_kernels(
        bt_f, 64, torch.float32, "bt4096-x64-k64")
    compare_kernels(bt_f, 64, torch.float64, "bt4096-x64-k64")
    rp_folds, rp_pairs, _, _ = compare_kernels(
        rp_f, 16, torch.float32, "rpa1024-x16-k16")
    compare_kernels(rp_f, 16, torch.float64, "rpa1024-x16-k16")
    times = time_kernels(folds, pairs)
    rp_times = time_kernels(rp_folds, rp_pairs)
    for label, tk in (("bt4096-x64-k64", times),
                      ("rpa1024-x16-k16", rp_times)):
        say(f"kernels {label} float32 levelfold per level "
            "(depth, K, ms, bound ms): " + ", ".join(
                f"({d}, {k}, {ms:.4f}, {b:.4f})"
                for d, k, ms, b in tk["levelfold"]["levels"]))
    for name, v in rp_times.items():
        say(f"kernels rpa1024-x16-k16 float32 {name}: {v['ms']:.4f} ms per "
            f"solve, plain {v['plain_ms']:.4f} ms, bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']})")

    # phase 3: the main path, full size
    _, launches = run_config("bt4096-x64-k64", bt_trees, bt_loads, None, 64,
                             (0, 21, 42, 63))
    # phase 4: the ragged path, with overrides
    run_config("rpa1024-x16-k16", rp_trees, rp_loads, rp_avail, 16,
               (0, 5, 10, 15), overrides=True)

    # phase 5 (random shapes) and phase 6 with phase 5 on its launches
    sr_err = check_segment_reduce_random()
    sr_launches, sr = reduce_path()
    sr_err = max(sr_err, sr["max_abs_err"])

    rows = []
    for name, src, replaces, n, err in (
            ("levelfold", "src/repro_torch/csrc/levelfold.cu",
             "src/repro/kernels/minplus/levelfold.py:267", launches[0],
             lf_err),
            ("minplus", "src/repro_torch/csrc/minplus.cu",
             "src/repro/kernels/minplus/minplus.py:38", launches[1],
             mp_err)):
        v = times[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n,
                     "max_abs_err": err, "ms": v["ms"],
                     "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                     "bound_by": v["bound_by"], "library_ms": None,
                     "bitwise": err == 0.0, "config": "bt4096-x64-k64",
                     "dtype": "float32"})
    rows.append({"name": "segment_reduce", "route": "cuda",
                 "source": "src/repro_torch/csrc/segment_reduce.cu",
                 "replaces": "src/repro/kernels/segment_reduce/"
                             "segment_reduce.py:32",
                 "launches": sr_launches, "max_abs_err": sr_err,
                 "ms": sr["ms"], "plain_ms": sr["plain_ms"],
                 "bound_ms": sr["bound_ms"], "bound_by": sr["bound_by"],
                 "library_ms": sr["library_ms"], "bitwise": sr_err == 0.0,
                 "config": "chip64-k16-d6.5m", "dtype": "float32"})
    say(json.dumps({"kernels": rows}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
