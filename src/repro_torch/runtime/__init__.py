"""Fault-tolerant orchestration on PyTorch: the port of the JAX package's
``runtime`` without its chaos harness (``faults``).

``Orchestrator`` owns the topology, the placement, the capacity ledgers
and the compiled :class:`~repro_torch.collectives.ReduceProgram`, and
turns every health event (a chip, switch or link failure, a capacity
loss, a straggler, a rescale, an admission wave) into a cached or solved
re-placement; the solves run the batched engine on ``options.device``.
``StragglerPolicy`` and ``elastic`` are host telemetry and topology
arithmetic in numpy.
"""
from .orchestrator import (JobRecord, Orchestrator, OrchestratorConfig,
                           PreemptionPolicy)
from .stragglers import StragglerPolicy, StragglerReport
from .elastic import fleet_dims, rescale, scaling_budget

__all__ = ["JobRecord", "Orchestrator", "OrchestratorConfig",
           "PreemptionPolicy", "StragglerPolicy",
           "StragglerReport", "fleet_dims", "rescale", "scaling_budget"]
