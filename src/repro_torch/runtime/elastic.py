"""Elastic scaling of the reduction fleet.

A copy of the JAX package's ``runtime/elastic.py`` over this package's
:func:`~repro_torch.collectives.topology.fleet_tree` and
:func:`~repro_torch.collectives.topology.fail_devices`.

``rescale`` rebuilds the cluster topology at a new size and maps the SOAR
budget onto it. Shrinks reuse the failure path (drop chips, zero load);
grows re-derive the fleet tree. The parameter/optimizer state itself is
re-sharded through the checkpoint layer (save on the old worker count,
restore on the new one), so elastic events are: drain -> checkpoint ->
rescale topology -> re-place blue nodes -> restore -> resume.
"""
from __future__ import annotations

from ..collectives.topology import ClusterTopology, fail_devices, fleet_tree


def fleet_dims(topo: ClusterTopology) -> tuple[int, int, int]:
    """Derive ``(n_pods, racks_per_pod, chips_per_rack)`` from a
    fleet-shaped topology (root spine -> pods -> racks[-> chip leaves]).

    Works for both :func:`~repro_torch.collectives.topology.fleet_tree` and
    :func:`~repro_torch.collectives.topology.chip_level_tree` outputs;
    raises on topologies that are not pod/rack regular.
    """
    t = topo.tree
    pods = t.children[t.root]
    if not pods:
        raise ValueError("not a fleet-shaped topology: root has no pods")
    n_pods = len(pods)
    racks_per_pod = len(t.children[pods[0]])
    if racks_per_pod == 0 or any(len(t.children[p]) != racks_per_pod
                                 for p in pods):
        raise ValueError("not a fleet-shaped topology: ragged pods")
    n_racks = n_pods * racks_per_pod
    if topo.n_devices == 0 or topo.n_devices % n_racks:
        raise ValueError("not a fleet-shaped topology: ragged racks")
    return n_pods, racks_per_pod, topo.n_devices // n_racks


def rescale(topo: ClusterTopology, n_pods: int | None = None,
            racks_per_pod: int | None = None,
            chips_per_rack: int | None = None) -> ClusterTopology:
    """Return a fresh fleet tree at the new size (grow or shrink).

    Dimensions left as ``None`` keep the current topology's value
    (derived via :func:`fleet_dims`), so ``rescale(topo, n_pods=4)``
    changes only the pod count.
    """
    cur_pods, cur_racks, cur_chips = fleet_dims(topo)
    return fleet_tree(
        n_pods=cur_pods if n_pods is None else n_pods,
        racks_per_pod=cur_racks if racks_per_pod is None else racks_per_pod,
        chips_per_rack=cur_chips if chips_per_rack is None else chips_per_rack)


def shrink_by_failure(topo: ClusterTopology, dead: list[int]) -> ClusterTopology:
    """In-place shrink: keep the tree, drop the dead chips' load."""
    return fail_devices(topo, dead)


def scaling_budget(k: int, old_devices: int, new_devices: int,
                   policy: str = "proportional") -> int:
    """How the blue budget moves when the fleet is rescaled.

    proportional: k scales with device count (NaaS per-tenant contract),
    rounded half to even as Python's ``round`` does;
    fixed: the tenant bought k switches, size changes don't alter it.
    """
    if policy == "fixed":
        return k
    if policy == "proportional":
        return max(1, round(k * new_devices / max(1, old_devices)))
    raise ValueError(f"unknown budget policy {policy!r}")
