"""Fault-tolerant orchestration on PyTorch: the port of the JAX package's
``runtime``.

``Orchestrator`` owns the topology, the placement, the capacity ledgers
and the compiled :class:`~repro_torch.collectives.ReduceProgram`, and
turns every health event (a chip, switch or link failure, a capacity
loss, a straggler, a rescale, an admission wave) into a cached or solved
re-placement; the solves run the batched engine on ``options.device``.
``StragglerPolicy`` and ``elastic`` are host telemetry and topology
arithmetic in numpy. ``faults`` is the chaos harness: seeded event
streams (``generate_scenario``), ``ChaosHarness``, which re-checks every
safety invariant after each event, and ``ChaosTrainer``, which takes a
real training step after each event on the orchestrator's device.
"""
from .orchestrator import (JobRecord, Orchestrator, OrchestratorConfig,
                           PreemptionPolicy)
from .stragglers import StragglerPolicy, StragglerReport
from .elastic import fleet_dims, rescale, scaling_budget
from .faults import (ChaosHarness, ChaosReport, ChaosTrainer,
                     FaultEvent, InvariantViolation,
                     generate_scenario)

__all__ = ["JobRecord", "Orchestrator", "OrchestratorConfig",
           "PreemptionPolicy", "StragglerPolicy",
           "StragglerReport", "fleet_dims", "rescale", "scaling_budget",
           "ChaosHarness", "ChaosReport", "ChaosTrainer", "FaultEvent",
           "InvariantViolation", "generate_scenario"]
