"""Sharding: logical-axis rules, parameter specs and DTensor placements
(``sharding``)."""
from .sharding import (
    AxisRules,
    PartitionSpec,
    axis_rules,
    cs,
    current_mesh,
    current_rules,
    logical_spec,
    make_rules,
    param_sharding_specs,
    placements,
)

__all__ = [
    "AxisRules", "PartitionSpec", "axis_rules", "cs", "current_mesh",
    "current_rules", "logical_spec", "make_rules", "param_sharding_specs",
    "placements",
]
