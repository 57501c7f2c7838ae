"""Host layer of the port: trees, the packed forest, the serial SOAR oracle.

A copy of what the batched solve, the reduce path and the penalty loop
need from the JAX package's ``core`` (the port imports nothing of that
package). Numpy only, apart from ``congestion``'s batched messages sweep,
which runs in torch on the engine's device.
"""
from .congestion import (FleetMeasurement, MultiFleetMeasurement,
                         congestion_profile, max_congestion, measure_fleet,
                         measure_fleet_multi, messages_up_batch,
                         messages_up_forest)
from .forest import (Forest, build_fleet_forest, build_forest,
                     forest_from_arrays, layout_key, layout_stats)
from .reduce import (agg_width, all_blue, all_red, mask_from_set,
                     messages_up, messages_up_degraded, phi, phi_barrier,
                     phi_degraded)
from .soar import SoarResult, soar, soar_color, soar_gather
from .tree import DEST, Tree, bt, random_tree, rpa, sample_load, with_rates
from .tropical import BIG, minplus, minplus_batch

__all__ = [
    "BIG", "DEST", "FleetMeasurement", "Forest", "MultiFleetMeasurement",
    "SoarResult", "Tree", "agg_width", "all_blue", "all_red", "bt",
    "build_fleet_forest", "build_forest", "congestion_profile",
    "forest_from_arrays", "layout_key", "layout_stats", "mask_from_set",
    "max_congestion", "measure_fleet", "measure_fleet_multi",
    "messages_up", "messages_up_batch", "messages_up_degraded",
    "messages_up_forest", "minplus", "minplus_batch", "phi",
    "phi_barrier", "phi_degraded", "random_tree", "rpa", "sample_load",
    "soar", "soar_color", "soar_gather", "with_rates",
]
