"""Placement -> reduction program -> the SOAR reduce, on PyTorch.

``topology`` builds the cluster trees and applies faults, ``schedule``
plans a placement (``plan``/``plan_batch`` over the batched engine,
``plan_congestion``/``plan_fleet`` over the penalty loop) and compiles it
into a :class:`ReduceProgram`. ``tree_allreduce`` executes the program
over all devices' buffers on one device; ``reduce_local`` executes it with
one rank per device over ``torch.distributed`` (each rank compiles its
part with ``compile_rank_program``). Numpy and torch only; nothing of the
JAX package.
"""
from .schedule import (CongestionPlan, FleetPlan, ReduceProgram, TenantPlan,
                       build_program, plan, plan_batch, plan_congestion,
                       plan_fleet)
from .topology import (ClusterTopology, Fleet, build_fleet, chip_level_tree,
                       degrade_links, degrade_switches, fail_devices,
                       fail_switches, fleet_tree, topology_from_arrays)
from .tree_allreduce import (compile_rank_program, reduce_local,
                             tree_allreduce, tree_allreduce_tree)

__all__ = [
    "CongestionPlan", "FleetPlan", "ReduceProgram", "TenantPlan",
    "build_program", "plan", "plan_batch", "plan_congestion", "plan_fleet",
    "ClusterTopology", "Fleet", "build_fleet", "chip_level_tree",
    "fleet_tree", "fail_devices", "fail_switches", "degrade_links",
    "degrade_switches", "topology_from_arrays",
    "tree_allreduce", "tree_allreduce_tree", "reduce_local",
    "compile_rank_program",
]
