"""Dry run of every (arch x shape x mesh) cell, one rank's step on a fake
process group: the port of the JAX package's ``launch/dryrun.py``.

JAX lowers and compiles each cell's jitted step for a mesh of 256 or 512
host devices, which proves the shardings coherent and gives
``memory_analysis`` and the HLO its roofline reads. The port has no
compiler to ask, so it runs the step as one rank of the mesh would:

* a fake process group (``torch.testing._internal.distributed.fake_pg``:
  every collective returns at once and moves nothing) makes this process
  rank 0 of the mesh's 256 (``--mesh single``, (16, 16)) or 512 (``multi``,
  (2, 16, 16)) ranks, over which ``make_production_mesh(device_type=
  "cpu")`` builds the mesh;
* the state and the batch or caches come from ``steps.abstract_state``,
  ``abstract_batch`` and ``abstract_caches`` (the meta device), are made
  fake CPU tensors under ``FakeTensorMode`` (shapes and dtypes, no
  storage, so a cell at production size takes no memory) and are placed
  as DTensors by ``param_pspecs``, ``opt_pspecs``, ``batch_pspecs`` and
  ``cache_pspecs`` under ``rules_for(mesh, shape, seq_shard)``. The step
  runs through ``FakeTensorMode`` and not the meta device because the
  kernel wrappers pick their path by device type: a CPU tensor takes the
  kernel's plain version, which the counter sees (``launch.roofline``),
  where a meta tensor would go to the CUDA launchers;
* one step runs inside ``roofline.StepCounter`` and
  ``torch.distributed._tools.mem_tracker.MemTracker``: training through
  ``launch.sharded.ShardedTrainStep`` (AdamW's moments bfloat16 above
  1e11 parameters and float32 below, as JAX's), prefill and decode
  through ``ShardedServeStep`` (decode at the sequence's last position,
  where every ``model`` rank's block of the caches is full). The steps
  gather the parameters a layer at a time and split the dense products
  and the vocabulary over ``model`` (``parallel.layer_gather``).

A cell's record, ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``,
is JAX's: ``status`` (``ok``; ``skipped`` with ``api.cell_supported``'s
reason; ``error`` with the exception and the tail of its traceback),
``params``, ``active_params``, ``n_devices``, ``times`` (the walls of the
set-up and of the fake step, on this host), ``memory`` (per device: the
argument bytes, this rank's shards of the parameters, the optimizer
state and the batch, or of the parameters, the caches and its token rows;
MemTracker's peak by category, the arguments filed as ``Other`` and what
the step makes as ``Activation``, since the functional model has no
``nn.Module`` to file it under, a kernel's plain version counted as the
kernel holds it, its outputs and no temporaries; ``fits``, the peak
against the card's ``HBM_BYTES``), ``roofline``, ``model_flops``, ``useful_flops_ratio``, and
``exchanges`` (``axis_ops.exchange_log``'s records summed by operation
and axis). A step that runs but would not fit the card stays ``ok`` with
``fits: false``. The sizes are counts from shapes: nothing ran on a
device, and no time here is a device's.

Importing this module touches no process group and no device:
:func:`fake_world` makes the group and destroys it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --force   # re-run
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from .. import tree as T
from ..collectives import axis_ops
from ..configs import ARCHS
from ..models import api
from ..models.config import ModelConfig
from ..optim import adamw
from . import roofline, sharded, steps
from .mesh import dp_size, make_production_mesh

OUT_DIR = pathlib.Path("experiments/dryrun_torch")
MESH_RANKS = {"single": 256, "multi": 512}


@contextlib.contextmanager
def fake_world(n_ranks: int, rank: int = 0):
    """The default process group as a fake one of ``n_ranks`` ranks, this
    process rank ``rank``, for the ``with`` block; destroyed after it,
    with the axis groups made over it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already")
    dist.init_process_group("fake", rank=rank, world_size=n_ranks,
                            store=FakeStore())
    try:
        yield
    finally:
        axis_ops.forget_groups()
        dist.destroy_process_group()


def _fake(tree):
    """Meta leaves -> fake CPU tensors of the same shapes, dtypes and
    ``requires_grad`` (under an active ``FakeTensorMode``)."""
    return T.tree_map(lambda m: torch.empty(
        m.shape, dtype=m.dtype, device="cpu").requires_grad_(
            m.requires_grad), tree)


def _moments_for(cfg: ModelConfig) -> str:
    """AdamW's moments: bfloat16 for trillion-scale cells, as JAX's."""
    return "bfloat16" if cfg.param_count() > 1e11 else "float32"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


def _local(tree):
    return T.tree_map(lambda d: d.to_local() if isinstance(d, DTensor)
                      else d, tree)


@dataclasses.dataclass
class CellRun:
    """One rank's step of a cell: the counter's records and their sums,
    the memory per device, the walls, the exchanges by operation and
    axis."""
    records: list
    stats: roofline.StepStats
    memory: dict
    times: dict
    exchanges: list


def _exchanges(log) -> list:
    out: dict = {}
    for r in log:
        key = (r["op"], "+".join(r["axis"]))
        e = out.setdefault(key, {"op": r["op"], "axis": key[1], "count": 0,
                                 "bytes": 0, "operand_bytes": 0})
        e["count"] += 1
        e["bytes"] += r["bytes"]
        e["operand_bytes"] += r["operand_bytes"]
    return list(out.values())


def _cell_args(cfg, shape, mesh, rules, ocfg):
    """(step, args, kwargs): the cell's step and this rank's DTensors
    (under an active ``FakeTensorMode``)."""
    params = _fake(steps.abstract_state(cfg))
    p = sharded.shard(params, mesh, steps.param_pspecs(params, rules))
    del params
    mode = shape.kind
    if mode == "train":
        batch = _fake(steps.abstract_batch(cfg, shape, "train"))
        b = sharded.shard(batch, mesh, steps.batch_pspecs(batch, mesh, shape))
        return (sharded.ShardedTrainStep(cfg, ocfg, mesh, rules),
                (p, sharded.init_opt(p, ocfg), b), {})
    if mode == "prefill":
        batch = _fake(steps.abstract_batch(cfg, shape, "prefill"))
        b = sharded.shard(batch, mesh, steps.batch_pspecs(batch, mesh, shape))
        return sharded.ShardedServeStep(cfg, mesh, rules, "prefill"), (p, b), {}
    caches = _fake(steps.abstract_caches(cfg, shape))
    c = sharded.shard(caches, mesh, steps.cache_pspecs(caches, mesh, shape))
    del caches
    rows = shape.global_batch
    if rows % dp_size(mesh) == 0:            # cache_pspecs' batch rule
        rows //= dp_size(mesh)
    step = sharded.ShardedServeStep(cfg, mesh, rules, "decode")
    token = torch.zeros((rows, 1), dtype=torch.int32)
    return step, (p, c, token), {"pos": _last_position(c, shape)}


def _last_position(caches, shape: api.ShapeSpec) -> int:
    """The sequence's last position the caches hold: the fewest positions
    of a ``SEQ_CACHES`` leaf (whole, not this rank's block), less one
    (the sequence's last when no leaf has positions). There every
    ``model`` rank's block of a full-attention cache is filled."""
    held = [d.shape[1 + any(n in ("layers", "dec") for n in p.split("/"))]
            for p, d in T.leaves_with_paths(caches)
            if p.split("/")[-1] in sharded.SEQ_CACHES]
    return (min(held) if held else shape.seq_len) - 1


@contextlib.contextmanager
def _kernel_peak(tracker):
    """Around a kernel's plain version: the kernel keeps the version's
    temporaries on chip, so MemTracker's peak over the call is what the
    call leaves (its outputs), not what the version held inside it."""
    peak = dict(tracker._peak_mem)
    snap = copy.deepcopy(tracker._peak_mem_snap)
    yield
    tracker._peak_mem, tracker._peak_mem_snap = peak, snap
    for dev, now in tracker._curr_mem_snap.items():
        if now["Total"] > peak.get(dev, 0):
            peak[dev] = now["Total"]
            snap[dev] = copy.deepcopy(now)


def run_cell_fake(cfg: ModelConfig, shape: api.ShapeSpec, mesh,
                  seq_shard: bool = False) -> CellRun:
    """One rank's step of (``cfg``, ``shape``) on ``mesh`` (a
    ``DeviceMesh`` over a fake process group; this rank's coordinate),
    counted and memory-tracked. Raises on any failure."""
    from torch.distributed._tools.mem_tracker import MemTracker
    rules = steps.rules_for(mesh, shape, seq_shard=seq_shard)
    ocfg = adamw.AdamWConfig(moment_dtype=_moments_for(cfg))
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, kw = _cell_args(cfg, shape, mesh, rules, ocfg)
        held = T.leaves(_local(list(args)))
        arg_bytes = _nbytes(held)
        setup_s = time.perf_counter() - t0
        tracker, counter = MemTracker(), roofline.StepCounter()
        tracker.track_external(*held)
        counter.around_kernel = functools.partial(_kernel_peak, tracker)
        t1 = time.perf_counter()
        with tracker, counter, axis_ops.exchange_log() as log:
            out = step(*args, **kw)
            del out
        step_s = time.perf_counter() - t1
    peak = next(iter(tracker.get_tracker_snapshot("peak").values()), {})
    by_cat = {getattr(k, "value", str(k)): v for k, v in peak.items()}
    total = by_cat.pop("Total", 0)
    memory = {"argument_bytes": arg_bytes, "peak_bytes": total,
              "peak_by_category": {k: v for k, v in by_cat.items() if v},
              "hbm_bytes": roofline.HBM_BYTES,
              "fits": total <= roofline.HBM_BYTES}
    return CellRun(counter.records, counter.stats(), memory,
                   {"setup_s": setup_s, "step_s": step_s}, _exchanges(log))


def count_unsharded(cfg: ModelConfig, shape: api.ShapeSpec,
                    part: str) -> roofline.StepCounter:
    """One process's ``part`` of (``cfg``, ``shape``), no mesh and no
    process group, counted on fake CPU tensors (a kernel's plain version
    as its kernel): ``"prefill"`` (``make_prefill_step`` on the batch) or
    ``"grads"`` (the loss and its gradient on a training batch: the
    trainer's worker step)."""
    if part not in ("prefill", "grads"):
        raise ValueError(f"part {part!r}: prefill or grads")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake(steps.abstract_state(cfg))
        batch = _fake(steps.abstract_batch(
            cfg, shape, "prefill" if part == "prefill" else "train"))
        with roofline.StepCounter() as counter:
            if part == "prefill":
                steps.make_prefill_step(cfg)(params, batch)
            else:
                loss, _ = api.loss_fn(cfg)(params, batch)
                torch.autograd.grad(loss, T.leaves(params))
    return counter


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             force: bool = False, **run_kw) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out_path = OUT_DIR / f"{arch}__{shape_name}__{mesh_kind}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = ARCHS[arch]
    shape = api.SHAPES[shape_name]
    ok, reason = api.cell_supported(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mode": shape.kind, "status": "skipped", "reason": reason,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if not ok:
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    n_dev = MESH_RANKS[mesh_kind]
    try:
        with fake_world(n_dev):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                        device_type="cpu")
            run = run_cell_fake(cfg, shape, mesh, **run_kw)
        terms = roofline.roofline_terms(run.stats, n_dev)
        mf = roofline.model_flops(cfg, shape, shape.kind)
        rec.update(
            status="ok",
            times=run.times,
            n_devices=n_dev,
            memory=run.memory,
            roofline=terms,
            model_flops=mf,
            useful_flops_ratio=(mf / terms["flops_global"]
                                if terms["flops_global"] else 0.0),
            exchanges=run.exchanges,
            n_ops=len(run.records),
        )
    except Exception as e:  # failure IS the signal: record and report later
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(api.SHAPES))
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seq-shard", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(api.SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mesh_kind, force=args.force,
                               seq_shard=args.seq_shard)
                dt = time.time() - t0
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" t>={r['step_time_lower_bound_s']:.3g}s"
                             f" useful={rec['useful_flops_ratio']:.2f}"
                             f" peak={rec['memory']['peak_bytes'] / 1e9:.1f}GB")
                elif status == "error":
                    extra = " " + rec["error"][:120]
                    failures.append((arch, shape, mesh_kind))
                print(f"[{status:7s}] {arch:20s} {shape:12s} {mesh_kind:6s}"
                      f" ({dt:6.1f}s){extra}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("ALL CELLS OK")


if __name__ == "__main__":
    main()
