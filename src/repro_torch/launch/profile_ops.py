"""Dry-run profiler: the roofline's bytes, FLOPs and collectives of one
rank's step attributed to the aten operators that make them; the port of
the JAX package's ``launch/profile_hlo.py``, named for what it reads:
there is no HLO here, only the operators ``roofline.StepCounter``
records.

For a given (arch, shape, mesh) cell it prints the top-N operators by
memory traffic, the memory by operator kind, the collective inventory and
the top dot operators, each row with its aten operator, its shapes and
where in the port it ran (the module and function; in a backward pass the
autograd node). The rows' totals are the step's ``StepStats``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.profile_ops --arch hymba-1.5b \\
      --shape train_4k --mesh single --top 25
"""
from __future__ import annotations

import argparse
import collections


def op_breakdown(records, top: int = 25):
    """(memory rows, collective rows, dot rows, memory by operator kind)
    of a step's :class:`~repro_torch.launch.roofline.OpRecord` list:
    ``(bytes, path, op, shapes)``, ``(bytes, path, op, kind, shapes)``,
    ``(flops, path, op, shapes)`` and a ``Counter`` op -> bytes. ``top``
    is the report's, kept for the JAX function's signature."""
    mem_by_kind = collections.Counter()
    mem_rows, coll_rows, flop_rows = [], [], []
    for r in records:
        if r.bytes:
            mem_rows.append((r.bytes, r.path, r.op, r.shapes))
            mem_by_kind[r.op] += r.bytes
        if r.collective:
            coll_rows.append((r.collective_bytes, r.path, r.op,
                              r.collective, r.shapes))
        if r.flops:
            flop_rows.append((r.flops, r.path, r.op, r.shapes))
    return mem_rows, coll_rows, flop_rows, mem_by_kind


def report(records, top: int = 25) -> None:
    mem_rows, coll_rows, flop_rows, mem_by_kind = op_breakdown(records, top)
    tot_mem = sum(r[0] for r in mem_rows)
    tot_coll = sum(r[0] for r in coll_rows)
    tot_flop = sum(r[0] for r in flop_rows)
    print(f"TOTAL mem={tot_mem/1e9:.2f} GB  coll={tot_coll/1e9:.3f} GB  "
          f"flops={tot_flop/1e12:.3f} T (per device)")
    print("\n-- memory by op kind --")
    for kind, b in mem_by_kind.most_common(12):
        print(f"  {kind:<28} {b/1e9:>10.2f} GB  "
              f"({100*b/max(tot_mem, 1):.1f}%)")
    print(f"\n-- top {top} memory ops --")
    for b, path, op, t in sorted(mem_rows, key=lambda r: -r[0])[:top]:
        print(f"  {b/1e9:>9.2f} GB  {op:<24} {t[:60]:<60} [{path[:60]}]")
    print("\n-- collectives --")
    agg = collections.Counter()
    for b, path, op, kind, t in coll_rows:
        agg[kind] += b
    for kind, b in agg.most_common():
        print(f"  {kind:<20} {b/1e9:>10.3f} GB")
    for b, path, op, kind, t in sorted(coll_rows, key=lambda r: -r[0])[:top]:
        print(f"  {b/1e6:>9.1f} MB  {kind:<18} {t[:50]:<50} [{path[:60]}]")
    print(f"\n-- top {min(top, 15)} dot ops --")
    for f, path, op, t in sorted(flop_rows,
                                 key=lambda r: -r[0])[:min(top, 15)]:
        print(f"  {f/1e12:>9.3f} TF  {op:<12} {t[:60]:<60} [{path[:60]}]")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--seq-shard", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCHS
    from ..models import api
    from .dryrun import MESH_RANKS, fake_world, run_cell_fake
    from .mesh import make_production_mesh

    cfg = ARCHS[args.arch]
    shape = api.SHAPES[args.shape]
    with fake_world(MESH_RANKS[args.mesh]):
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type="cpu")
        run = run_cell_fake(cfg, shape, mesh, seq_shard=args.seq_shard)
    print(f"[{args.arch} x {args.shape} x {args.mesh}] "
          f"setup={run.times['setup_s']:.1f}s step={run.times['step_s']:.1f}s"
          f" (fake tensors on this host) ops={len(run.records)}")
    report(run.records, args.top)
    return run


if __name__ == "__main__":
    main()
