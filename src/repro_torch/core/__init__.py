"""Host layer of the port: trees, the packed forest, the serial SOAR oracle.

Numpy only; a copy of what the batched solve needs from the JAX package's
``core`` (the port imports nothing of that package).
"""
from .forest import (Forest, build_fleet_forest, build_forest,
                     forest_from_arrays, layout_key, layout_stats)
from .reduce import messages_up, phi
from .soar import SoarResult, soar, soar_color, soar_gather
from .tree import DEST, Tree, bt, random_tree, rpa, sample_load, with_rates
from .tropical import BIG, minplus, minplus_batch

__all__ = [
    "BIG", "DEST", "Forest", "SoarResult", "Tree", "bt",
    "build_fleet_forest", "build_forest", "forest_from_arrays",
    "layout_key", "layout_stats", "messages_up", "minplus", "minplus_batch",
    "phi", "random_tree", "rpa", "sample_load", "soar", "soar_color",
    "soar_gather", "with_rates",
]
