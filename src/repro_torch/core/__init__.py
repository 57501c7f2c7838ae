"""Host layer of the port: trees, the packed forest, the serial SOAR oracle,
and the paper's evaluation models.

A copy of the JAX package's ``core`` (the port imports nothing of that
package): what the batched solve, the reduce path and the penalty loop
need, and the vectorised gather (``soar_fast``), the brute-force oracle,
the online allocator, the byte-complexity models, the bottleneck solver
(``bottleneck``) and the cross-workload budget split (``budget``). Numpy
only, apart from ``congestion``'s batched messages sweep, which runs in
torch on the engine's device.
"""
from .baselines import STRATEGIES, level, max_degree, max_load, random_k, top
from .brute import brute_force
from .bytes_model import ParameterServerModel, WordCountModel, byte_complexity
from .congestion import (FleetMeasurement, MultiFleetMeasurement,
                         congestion_profile, max_congestion, measure_fleet,
                         measure_fleet_multi, messages_up_batch,
                         messages_up_forest)
from .forest import (Forest, build_fleet_forest, build_forest,
                     forest_from_arrays, layout_key, layout_stats)
from .online import OnlineResult, online_allocate, workload_stream
from .reduce import (agg_width, all_blue, all_red, mask_from_set,
                     messages_up, messages_up_degraded, phi, phi_barrier,
                     phi_degraded)
from .soar import SoarResult, soar, soar_color, soar_gather
from .soar_fast import soar_fast, soar_gather_vectorized
from .tree import DEST, Tree, bt, random_tree, rpa, sample_load, with_rates
from .tropical import BIG, minplus, minplus_batch

__all__ = [
    "BIG", "DEST", "FleetMeasurement", "Forest", "MultiFleetMeasurement",
    "OnlineResult", "ParameterServerModel", "STRATEGIES", "SoarResult",
    "Tree", "WordCountModel", "agg_width", "all_blue", "all_red",
    "brute_force", "bt", "build_fleet_forest", "build_forest",
    "byte_complexity", "congestion_profile", "forest_from_arrays",
    "layout_key", "layout_stats", "level", "mask_from_set", "max_congestion",
    "max_degree", "max_load", "measure_fleet", "measure_fleet_multi",
    "messages_up", "messages_up_batch", "messages_up_degraded",
    "messages_up_forest", "minplus", "minplus_batch", "online_allocate",
    "phi", "phi_barrier", "phi_degraded", "random_k", "random_tree", "rpa",
    "sample_load", "soar", "soar_color", "soar_fast", "soar_gather",
    "soar_gather_vectorized", "top", "with_rates", "workload_stream",
]
