"""Deterministic chaos harness for the fault-tolerant orchestrator: the
port of the JAX package's ``runtime/faults.py``.

Reliability claims about the recovery path are only as good as the event
sequences they were tested under. This module makes those sequences
*reproducible*: :func:`generate_scenario` derives a feasibility-checked
event stream from a seed (device/switch/link faults, straggler storms,
correlated rack failures, recoveries, link-degrade preplanning that later
degrade events replay against the cache, optional multi-workload
admissions — including device-side hard-admission waves, preemptive
admissions under a :class:`~repro_torch.runtime.PreemptionPolicy`, and job
releases), draw for draw the JAX package's stream,
and :class:`ChaosHarness` steps an :class:`~repro_torch.runtime.Orchestrator`
through it, re-checking the system's safety invariants after *every*
event:

  * the blue budget is respected and no blue sits on a blocked switch;
  * per-switch capacity residuals never go negative, the claim
    ledger balances (capacity handed out == blue claims live), and
    every tree's residual plus its registered job claims reconstructs
    the effective per-switch capacity exactly;
  * the installed program's utilization equals ``phi_degraded``
    recomputed from the current topology, mask, and per-switch capacity
    scales — the program is never stale, and never aggregates on a
    zero-capacity plane;
  * whenever a recovery was served from the preplan cache, a fresh
    engine solve of the same scenario (on the orchestrator's engine
    device, the card unless its ``options`` say otherwise) must reproduce
    the cached placement bit-for-bit (the cache can be fast, never wrong);
  * the fleet keeps a quorum of healthy devices.

A violated invariant raises :class:`InvariantViolation` naming the event
and the failed check, so a chaos run doubles as a regression bisection
tool: replay the same seed, stop at the same event.

:class:`ChaosTrainer` couples the harness to real training steps of the
port's trainer (``repro_torch.launch.train.make_step``): the ``n_dev``
data-parallel workers simulated on the orchestrator's engine device, or,
given a process group of ``n_dev`` ranks, one worker a rank (each rank
running the same harness events, as the JAX class steps over a mesh of
devices). Its checkpoints hold ``{"params", "opt"}`` as the JAX class's
do; the port's ``train.main`` also saves the error feedback (ROADMAP C9),
which this trainer never uses (it does not compress).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import tree as T
from ..collectives.schedule import build_program, plan
from ..core.reduce import phi_degraded
from .orchestrator import Orchestrator, OrchestratorConfig, PreemptionPolicy

KINDS = ("fail_device", "recover_device", "fail_switch", "recover_switch",
         "degrade_link", "recover_link", "straggler_storm",
         "recover_quarantined", "fail_rack", "admit_workloads",
         "preplan_links", "degrade_switch", "recover_switch_capacity",
         "crash", "admit_jobs", "preempt_admit", "release_jobs")

#: preemption policies preempt_admit events cycle through
POLICIES = PreemptionPolicy.KINDS

DEGRADE_FACTORS = (0.5, 0.25, 0.125)
# partial aggregation-capacity loss fractions for degrade_switch events
CAP_FRACS = (0.75, 0.5, 0.25)


class InvariantViolation(AssertionError):
    """A safety invariant failed after a chaos event."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected event. Only the fields its ``kind`` uses are set."""
    kind: str
    devices: tuple = ()       # fail/recover_device, storm slow set, rack
    switches: tuple = ()      # fail/recover_switch, rack switch
    rates: tuple = ()         # degrade/recover_link: ((switch, fraction),)
    steps: int = 0            # straggler_storm: observed steps
    slow: float = 8.0         # straggler_storm: slow-device duration
    count: int = 0            # admit_workloads / admit_jobs / release_jobs
    policy: str = ""          # preempt_admit: PreemptionPolicy kind


@dataclasses.dataclass
class ChaosReport:
    """What a chaos run did and what it cost."""
    records: list             # per-event dicts (kind, util, cache_hit, ...)
    events: int
    replans: int              # engine solves the orchestrator performed
    cache_hits: int           # recoveries served by the preplan cache
    stale: int                # cache entries evicted for capacity drift
    invariant_checks: int
    seconds: float
    train: dict | None = None  # ChaosTrainer summary when training-coupled

    @property
    def events_per_sec(self) -> float:
        return self.events / self.seconds if self.seconds > 0 else 0.0


def _storm_limit(n_alive: int, quantile: float) -> int:
    """Max slow devices a storm may have while still guaranteeing the
    deadline quantile stays at the fast-device level (linear-interpolation
    quantile: index q*(H-1) must not reach the m slow order statistics)."""
    return int(np.floor((n_alive - 1) * (1.0 - quantile)))


def generate_scenario(topo, n_events: int = 50, seed: int = 0,
                      cfg: OrchestratorConfig | None = None,
                      admits: bool = False,
                      min_healthy: int | None = None,
                      train: bool = False) -> list[FaultEvent]:
    """Derive a deterministic, feasibility-checked event sequence.

    Mirrors the orchestrator's health state (failed / quarantined devices,
    blocked switches, degraded links, partially-degraded aggregation
    planes) while sampling, so every emitted event is valid when it
    arrives: no double-failures, the fleet never drops below
    ``min_healthy`` live devices (default ``max(2, n/4)``), at most half
    the switches are ever blocked, and straggler storms are sized so the
    deadline math *guarantees* the slow devices get quarantined (slow
    count <= ``(alive-1) * (1-quantile)``, exactly ``patience`` observed
    steps). ``train=True`` additionally mixes in ``crash`` events —
    process loss that only a :class:`ChaosTrainer` (checkpoint restart)
    can absorb. The same ``(topo, n_events, seed, cfg, train)`` always
    yields the same list.
    """
    cfg = cfg or OrchestratorConfig()
    rng = np.random.default_rng(seed)
    n_dev = topo.n_devices
    n_sw = topo.tree.n
    if min_healthy is None:
        min_healthy = max(2, n_dev // 4)
    racks: dict[int, list[int]] = {}
    for dev, leaf in enumerate(topo.device_leaf):
        racks.setdefault(int(leaf), []).append(dev)

    failed: set[int] = set()
    quarantined: set[int] = set()
    blocked: set[int] = set()
    live_jobs = 0   # mirrored registry size (upper bound; release is lenient)
    degraded: dict[int, float] = {}
    cap_degraded: dict[int, float] = {}   # partially-degraded agg planes
    # link-degrade what-ifs the stream has preplanned; later degrade_link
    # events preferentially replay them, exercising the cache-served
    # recovery path (preplan_link_degrades -> on_link_degrade lookup)
    preplanned_links: list[tuple[int, float]] = []

    def healthy() -> list[int]:
        return [d for d in range(n_dev)
                if d not in failed and d not in quarantined]

    events: list[FaultEvent] = []
    while len(events) < n_events:
        alive = healthy()
        menu: list[tuple[str, float]] = []
        if len(alive) - 1 >= min_healthy:
            menu.append(("fail_device", 3.0))
        if failed:
            menu.append(("recover_device", 3.0))
        if len(blocked) + 1 <= n_sw // 2:
            menu.append(("fail_switch", 2.0))
        if blocked:
            menu.append(("recover_switch", 2.0))
        menu.append(("degrade_link", 2.0))
        if degraded:
            menu.append(("recover_link", 2.0))
        if len(degraded) < n_sw:
            menu.append(("preplan_links", 1.0))
        cap_ok = [v for v in range(n_sw)
                  if v not in cap_degraded and v not in blocked]
        if cap_ok:
            menu.append(("degrade_switch", 2.0))
        if cap_degraded:
            menu.append(("recover_switch_capacity", 2.0))
        if train:
            menu.append(("crash", 0.5))
        storm_cap = min(_storm_limit(len(alive), cfg.straggler_quantile),
                        len(alive) - min_healthy)
        if storm_cap >= 1:
            menu.append(("straggler_storm", 1.0))
        if quarantined:
            menu.append(("recover_quarantined", 1.0))
        # membership against a set: the list is kept for sampling, where
        # its order fixes the stream (a list here is quadratic in the fleet)
        alive_set = set(alive)
        rack_ok = [r for r, devs in racks.items()
                   if r not in blocked
                   and len(blocked) + 1 <= n_sw // 2
                   and any(d in alive_set for d in devs)
                   and len(alive) - sum(d in alive_set for d in devs)
                   >= min_healthy]
        if rack_ok:
            menu.append(("fail_rack", 1.0))
        if admits:
            menu.append(("admit_workloads", 1.0))
            menu.append(("admit_jobs", 1.0))
            if live_jobs:
                menu.append(("preempt_admit", 1.0))
                menu.append(("release_jobs", 1.0))

        kinds = [k for k, _ in menu]
        w = np.asarray([w for _, w in menu])
        kind = str(rng.choice(kinds, p=w / w.sum()))

        if kind == "fail_device":
            m = int(rng.integers(1, min(2, len(alive) - min_healthy) + 1))
            devs = rng.choice(alive, size=m, replace=False)
            failed.update(int(d) for d in devs)
            events.append(FaultEvent("fail_device",
                                     devices=tuple(sorted(int(d)
                                                          for d in devs))))
        elif kind == "recover_device":
            m = int(rng.integers(1, min(2, len(failed)) + 1))
            devs = rng.choice(sorted(failed), size=m, replace=False)
            failed.difference_update(int(d) for d in devs)
            events.append(FaultEvent("recover_device",
                                     devices=tuple(sorted(int(d)
                                                          for d in devs))))
        elif kind == "fail_switch":
            s = int(rng.choice([v for v in range(n_sw) if v not in blocked]))
            blocked.add(s)
            events.append(FaultEvent("fail_switch", switches=(s,)))
        elif kind == "recover_switch":
            s = int(rng.choice(sorted(blocked)))
            blocked.discard(s)
            events.append(FaultEvent("recover_switch", switches=(s,)))
        elif kind == "degrade_link":
            # half the time replay a preplanned what-if (when one is still
            # applicable): its fingerprint matches iff no other link state
            # changed since the preplan, so the stream exercises both the
            # cache-hit and the honest-miss recovery paths
            usable = [(v, f) for v, f in preplanned_links
                      if v not in degraded]
            if usable and rng.random() < 0.5:
                v, f = usable[int(rng.integers(len(usable)))]
            else:
                v = int(rng.integers(0, n_sw))
                f = float(rng.choice(DEGRADE_FACTORS))
            degraded[v] = f
            events.append(FaultEvent("degrade_link", rates=((v, f),)))
        elif kind == "recover_link":
            v = int(rng.choice(sorted(degraded)))
            del degraded[v]
            events.append(FaultEvent("recover_link", rates=((v, 1.0),)))
        elif kind == "degrade_switch":
            s = int(rng.choice(cap_ok))
            f = float(rng.choice(CAP_FRACS))
            cap_degraded[s] = f
            events.append(FaultEvent("degrade_switch", rates=((s, f),)))
        elif kind == "recover_switch_capacity":
            s = int(rng.choice(sorted(cap_degraded)))
            del cap_degraded[s]
            events.append(FaultEvent("recover_switch_capacity",
                                     rates=((s, 1.0),)))
        elif kind == "crash":
            events.append(FaultEvent("crash"))
        elif kind == "straggler_storm":
            m = int(rng.integers(1, storm_cap + 1))
            devs = rng.choice(alive, size=m, replace=False)
            quarantined.update(int(d) for d in devs)
            events.append(FaultEvent(
                "straggler_storm",
                devices=tuple(sorted(int(d) for d in devs)),
                steps=cfg.straggler_patience, slow=8.0))
        elif kind == "recover_quarantined":
            quarantined.clear()
            events.append(FaultEvent("recover_quarantined"))
        elif kind == "fail_rack":
            r = int(rng.choice(rack_ok))
            devs = tuple(sorted(d for d in racks[r] if d in alive_set))
            failed.update(devs)
            blocked.add(r)
            events.append(FaultEvent("fail_rack", devices=devs,
                                     switches=(r,)))
        elif kind == "preplan_links":
            cand = [v for v in range(n_sw) if v not in degraded]
            m = int(rng.integers(1, min(3, len(cand)) + 1))
            vs = rng.choice(cand, size=m, replace=False)
            pairs = tuple(
                (int(v), float(rng.choice(DEGRADE_FACTORS)))
                for v in sorted(int(v) for v in vs))
            preplanned_links.extend(pairs)
            events.append(FaultEvent("preplan_links", rates=pairs))
        elif kind == "admit_jobs":
            c = int(rng.integers(1, 3))
            live_jobs += c
            events.append(FaultEvent("admit_jobs", count=c))
        elif kind == "preempt_admit":
            c = int(rng.integers(1, 3))
            live_jobs += c          # admitted wave joins the registry
            events.append(FaultEvent("preempt_admit", count=c,
                                     policy=str(rng.choice(POLICIES))))
        elif kind == "release_jobs":
            c = int(rng.integers(1, 3))
            live_jobs = max(0, live_jobs - c)
            events.append(FaultEvent("release_jobs", count=c))
        else:  # admit_workloads
            c = int(rng.integers(1, 3))
            live_jobs += c
            events.append(FaultEvent("admit_workloads", count=c))
    return events


class ChaosHarness:
    """Steps an orchestrator through fault events, checking invariants.

    ``verify_cache_hits=True`` (the default, and the expensive part) runs
    a fresh engine solve after every cache-served recovery and requires
    the placement to match the cached one bit-for-bit.

    Pass a :class:`ChaosTrainer` as ``trainer`` to drive a *real*
    training step after every event (training-coupled chaos): events
    that neither removed a contributing device nor moved the blue
    placement are **lossless** and the step's result must be bit-identical
    to the fault-free program's — the executor's degraded-mode spill is
    exact, not approximate. ``crash`` events restart the trainer from
    its latest checkpoint; without a trainer they are no-ops.
    """

    def __init__(self, orch: Orchestrator, verify_cache_hits: bool = True,
                 trainer: "ChaosTrainer | None" = None):
        self.orch = orch
        self.verify_cache_hits = verify_cache_hits
        self.trainer = trainer
        self.invariant_checks = 0
        # the observable capacity ledger: whatever is unclaimed now plus
        # this workload's own claim. Extra admissions are tracked as they
        # happen so the balance stays checkable.
        if orch._residual is not None:
            self._capacity_total = int(orch._residual.sum()
                                       + int(orch.blue.sum()))
        else:
            self._capacity_total = None
        self._extra_claims = 0

    # -- event dispatch -------------------------------------------------------
    def step(self, ev: FaultEvent) -> dict:
        """Apply one event, then re-check every invariant."""
        o = self.orch
        hits0 = o._preplan_stats["hits"]
        pre_contrib = (o.alive & ~o.quarantined).copy()
        pre_blue = None if o.blue is None else o.blue.copy()
        if ev.kind == "fail_device":
            o.on_failure(list(ev.devices))
        elif ev.kind == "recover_device":
            o.on_recover(list(ev.devices))
        elif ev.kind == "fail_switch":
            o.on_switch_failure(list(ev.switches))
        elif ev.kind == "recover_switch":
            o.on_switch_recover(list(ev.switches))
        elif ev.kind in ("degrade_link", "recover_link"):
            o.on_link_degrade(dict(ev.rates))
        elif ev.kind == "straggler_storm":
            durations = np.ones(o.topo0.n_devices)
            durations[list(ev.devices)] = ev.slow
            for _ in range(ev.steps):
                o.on_step_durations(durations)
        elif ev.kind == "recover_quarantined":
            quarantined = np.nonzero(o.quarantined)[0].tolist()
            if quarantined:                       # no-op if nothing is held
                o.on_recover(quarantined)
        elif ev.kind == "fail_rack":
            # correlated fault domain: the rack's chips die with the
            # rack switch's aggregation plane
            o.on_failure(list(ev.devices))
            o.on_switch_failure(list(ev.switches))
        elif ev.kind == "preplan_links":
            # one single-link what-if per preplanned pair: the matching
            # real degrade_link later in the stream becomes a cache lookup
            o.preplan_link_degrades([{v: f} for v, f in ev.rates])
        elif ev.kind == "admit_workloads":
            before = int(o._residual.sum())
            o.begin_workloads(ev.count)
            self._extra_claims += before - int(o._residual.sum())
        elif ev.kind in ("admit_jobs", "preempt_admit"):
            # hard admission inside the device penalty loop; preempt_admit
            # additionally arms a preemption policy so a wave that cannot
            # fit evicts victims instead of failing
            before = int(o._residual.sum())
            policy = (PreemptionPolicy(kind=ev.policy or "priority")
                      if ev.kind == "preempt_admit" else None)
            o.begin_workloads(ev.count, congestion_aware=True,
                              device_admission=True, preemption=policy,
                              max_rounds=2)
            self._extra_claims += before - int(o._residual.sum())
        elif ev.kind == "release_jobs":
            ids = sorted(o.jobs)[:ev.count]
            if ids:
                before = int(o._residual.sum())
                o.release_workloads(ids)
                self._extra_claims += before - int(o._residual.sum())
        elif ev.kind in ("degrade_switch", "recover_switch_capacity"):
            o.on_switch_degrade(dict(ev.rates))
            rec = o.degraded_events[-1]
            if self._capacity_total is not None:
                # the observable capacity pool shrank/grew with the plane,
                # and evicted foreign claims leave the admitted ledger
                self._capacity_total += rec["capacity_delta"]
                self._extra_claims -= rec["evicted_foreign"]
        elif ev.kind == "crash":
            pass  # orchestrator state survives; the trainer restarts below
        else:
            raise ValueError(f"unknown event kind {ev.kind!r}")
        cache_hit = o._preplan_stats["hits"] > hits0
        self.check_invariants(cache_hit=cache_hit, event=ev)
        record = {
            "kind": ev.kind,
            "utilization": o.program.utilization,
            "cache_hit": cache_hit,
            "n_alive": o.n_alive,
            "replans": o.replans,
        }
        if self.trainer is not None:
            lossless = (ev.kind != "crash" and pre_blue is not None
                        and o.blue is not None
                        and np.array_equal(pre_contrib,
                                           o.alive & ~o.quarantined)
                        and np.array_equal(pre_blue, o.blue))
            record.update(self.trainer.after_event(ev, lossless=lossless))
        return record

    # -- invariants -----------------------------------------------------------
    def check_invariants(self, cache_hit: bool = False,
                         event: FaultEvent | None = None) -> None:
        o = self.orch
        where = f" after {event.kind} {event!r}" if event else ""

        def _require(ok: bool, msg: str) -> None:
            if not ok:
                raise InvariantViolation(msg + where)

        _require(o.n_alive > 0, "no healthy devices left")
        _require(int(o.blue.sum()) <= o.cfg.k,
                 f"blue count {int(o.blue.sum())} exceeds budget {o.cfg.k}")
        _require(not np.any(o.blue & o.switch_blocked),
                 "blue placement on a blocked switch")
        if o.topo.cap_scale is not None:
            _require(not np.any(o.blue & (o.topo.cap_scale <= 0)),
                     "blue placement on a zero-capacity switch")
        if o._residual is not None:
            _require(bool((o._residual >= 0).all()),
                     f"negative capacity residual "
                     f"{o._residual.min()} at switch "
                     f"{int(o._residual.argmin())}")
            handed_out = self._capacity_total - int(o._residual.sum())
            _require(handed_out == int(o.blue.sum()) + self._extra_claims,
                     f"claim ledger imbalance: {handed_out} capacity "
                     f"claimed vs {int(o.blue.sum())} blue + "
                     f"{self._extra_claims} admitted")
            # per-switch conservation: each tree's residual plus the job
            # registry's claims against it (and the orchestrator's own
            # blue on tree 0) must reconstruct the effective capacity of
            # every switch exactly — no claim leaks, no double-frees
            eff0 = np.asarray([o._effective_capacity(sc)
                               for sc in o._switch_scale], np.int64)
            for g, res_g in enumerate(o._residuals):
                if res_g is None:
                    continue
                total = res_g.astype(np.int64, copy=True)
                for j in o.jobs.values():
                    if j.tree == g:
                        total += j.blue.astype(np.int64)
                if g == 0:
                    total += o.blue.astype(np.int64)
                    eff = eff0
                else:
                    eff = np.full(res_g.shape[0], o.cfg.capacity,
                                  np.int64)
                if not np.array_equal(total, eff):
                    s = int(np.nonzero(total != eff)[0][0])
                    _require(False,
                             f"per-switch claim conservation broken on "
                             f"tree {g} switch {s}: residual+claims "
                             f"{int(total[s])} != effective capacity "
                             f"{int(eff[s])}")
        fresh_util = phi_degraded(o.topo.tree, o.topo.load, o.blue,
                                  o.topo.cap_scale)
        _require(o.program.utilization == fresh_util,
                 f"program utilization {o.program.utilization} != "
                 f"phi of current placement {fresh_util}")
        if cache_hit and self.verify_cache_hits:
            # on the orchestrator's own engine device, as its _plan solves
            # (a baseline strategy takes no engine options)
            opts = o.options if o.cfg.strategy == "soar" else None
            blue, prog = plan(o.topo, o.cfg.k, avail=o._replan_avail(),
                              strategy=o.cfg.strategy, options=opts)
            _require(bool(np.array_equal(blue, o.blue)),
                     "cache-served placement differs from a fresh solve")
            _require(prog.utilization == o.program.utilization,
                     f"cache-served utilization {o.program.utilization} != "
                     f"fresh solve {prog.utilization}")
        self.invariant_checks += 1

    # -- driver ---------------------------------------------------------------
    def run(self, events: list[FaultEvent]) -> ChaosReport:
        """Step through all events; returns the run's report."""
        o = self.orch
        replans0, hits0 = o.replans, o._preplan_stats["hits"]
        t0 = time.perf_counter()
        records = [self.step(ev) for ev in events]
        dt = time.perf_counter() - t0
        return ChaosReport(
            records=records,
            events=len(events),
            replans=o.replans - replans0,
            cache_hits=o._preplan_stats["hits"] - hits0,
            stale=o._preplan_stats["stale"],
            invariant_checks=self.invariant_checks,
            seconds=dt,
            train=None if self.trainer is None else self.trainer.summary(),
        )


class ChaosTrainer:
    """Real training steps interleaved with chaos events.

    Couples the chaos harness to the end-to-end driver: a tiny model
    trains with the orchestrator's *live* SOAR reduction program, one
    step per event, so recovery claims are checked against actual
    gradient arithmetic rather than cost accounting alone:

      * **lossless events** (no contributing device lost, blue placement
        unchanged — e.g. partial capacity degrades, link degrades) must
        leave the step *bit-identical* to the fault-free program's: the
        step runs twice from the same state, once under the pristine
        ``cap_scale=None`` program on copies of the state and once under
        the installed (possibly degraded/spilling) program on the state
        itself (the port's step updates its state in place), and every
        parameter, optimizer slot and the loss must match bitwise (the
        strict-left-fold spill construction is exact, not approximate);
      * **crash events** restart from the latest checkpoint, asserting
        the restored state is bitwise what was saved, and rewinding the
        step counter — the unrecoverable-event path.

    The model, data and optimizer state live on the orchestrator's engine
    device (``orch.options.device``; the card when ``options`` is None).
    Without ``group`` the topology's ``n_dev`` workers are simulated
    there, each on its shard of the batch. With a process ``group`` of
    ``n_dev`` ranks, each rank builds its own orchestrator and trainer,
    runs the same events, and trains its own worker (its rank in the
    group), the gradients reduced by ``reduce_local``; a lossless event's
    bitwise check runs on every rank, rank 0 writes the checkpoints and
    every rank restores them. Step functions are cached by (load, blue,
    cap-scale, grad-scale); the first step on a program state is recorded
    with a ``compiled`` flag (the JAX class compiles there), so throughput
    stats can exclude those steps.
    """

    def __init__(self, orch: Orchestrator, arch: str = "qwen3-32b",
                 seq: int = 32, global_batch: int | None = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 5,
                 seed: int = 0, group=None):
        from ..checkpoint import ckpt as _ckpt
        from ..configs import ARCHS
        from ..data.pipeline import DataConfig, SyntheticLM
        from ..models import api
        from ..optim import adamw
        from ..optim.compression import (CompressionConfig,
                                         init_error_feedback)

        self.orch = orch
        self.device = torch.device(
            "cuda" if orch.options is None else orch.options.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: build the orchestrator with "
                "options=EngineOptions(device=\"cpu\") to train on the CPU")
        n_dev = orch.topo0.n_devices
        self.n_dev = n_dev
        self.group, self.rank = group, 0
        if group is not None:
            if dist.get_world_size(group) != n_dev:
                raise ValueError(f"orchestrator topology has {n_dev} "
                                 f"devices but the group "
                                 f"{dist.get_world_size(group)} ranks")
            self.rank = dist.get_rank(group)
        self.cfg = ARCHS[arch].reduced()
        self.ocfg = adamw.AdamWConfig()
        self.ccfg = CompressionConfig()
        self.global_batch = global_batch or max(4, n_dev)
        if self.global_batch % n_dev:
            raise ValueError(f"global_batch {self.global_batch} not "
                             f"divisible by {n_dev} devices")
        self.seq = seq
        self.data = SyntheticLM(self.cfg,
                                DataConfig(self.global_batch, seq,
                                           seed=seed), device=self.device)
        self.params = api.init_fn(self.cfg, self.device)(seed)
        self.opt_state = adamw.init(self.params, self.ocfg)
        self.ef = init_error_feedback(self.params)
        if n_dev > 1 and group is None:
            # one row per simulated worker, as train.main stacks it
            self.ef = T.tree_map(
                lambda e: e.new_zeros((n_dev,) + tuple(e.shape)), self.ef)
        self.step_no = 0
        self.steps_run = 0      # executed steps; unlike step_no, never rewinds
        self.losses: list[float] = []
        self.step_times: list[tuple[float, bool]] = []  # (secs, compiled)
        self.bitwise_checks = 0
        self.restores = 0
        self._step_fns: dict[tuple, object] = {}
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = int(ckpt_every)
        self._ckpt = _ckpt
        self._saved: dict | None = None
        if ckpt_dir is not None:
            # synchronous saves: a crash may arrive on the very next event
            self.mgr = _ckpt.CheckpointManager(ckpt_dir, async_save=False)
            self._save()
        else:
            self.mgr = None

    # -- checkpointing --------------------------------------------------------
    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def _save(self) -> None:
        if self.rank == 0:
            self.mgr.save(self.step_no, self._state())
        if self.group is not None:          # saved before any rank restores
            dist.barrier(group=self.group)
        # a host copy, as JAX's device_get: later steps write in place
        self._saved = {"step": self.step_no,
                       "state": T.tree_map(
                           lambda t: t.detach().to("cpu", copy=True),
                           self._state())}

    def crash_restore(self) -> None:
        """Process loss: rebuild training state from the latest checkpoint.

        Asserts the restored tree is *bitwise* the one that was saved
        (checkpoint integrity), then installs it in the live tensors and
        rewinds the step counter so the data pipeline replays the same
        batches.
        """
        if self.mgr is None:
            raise InvariantViolation(
                "crash event without a checkpoint directory")
        state, step = self._ckpt.restore(self.ckpt_dir, self._state())
        if self._saved is not None:
            _assert_trees_bitwise(
                state, self._saved["state"],
                what=f"checkpoint restore at step {step}")
            if step != self._saved["step"]:
                raise InvariantViolation(
                    f"restored step {step} != last saved "
                    f"{self._saved['step']}")
        with torch.no_grad():
            for dst, src in zip(T.leaves(self._state()), T.leaves(state),
                                strict=True):
                dst.copy_(src)
        self.step_no = int(step)
        del self.losses[self.step_no:]
        self.restores += 1

    # -- stepping -------------------------------------------------------------
    def _step_fn(self, program, grad_scale: float, pristine: bool = False):
        """make_step, cached by everything the step closes over.

        ``pristine`` marks the fault-free reference program (built with
        ``cap_scale=None``); when no degrade is active it shares the
        live program's cache entry.
        """
        o = self.orch
        scale_key = (b"" if pristine or o.topo.cap_scale is None
                     else np.asarray(o.topo.cap_scale).tobytes())
        key = (o.topo.load.tobytes(),
               b"" if o.blue is None else o.blue.tobytes(),
               scale_key, float(grad_scale))
        fresh = key not in self._step_fns
        if fresh:
            from ..launch.train import make_step
            self._step_fns[key] = make_step(self.cfg, self.ocfg, program,
                                            grad_scale, self.ccfg,
                                            group=self.group)
        return self._step_fns[key], fresh

    def _run(self, fn, state, batch):
        out = fn(*state, batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def train_step(self, check_bitwise: bool = False) -> dict:
        """One optimizer step with the orchestrator's current program.

        With ``check_bitwise`` copies of the state first step through the
        fault-free (``cap_scale=None``) program, and the live step's
        result must agree with theirs bit-for-bit.
        """
        from ..launch.train import mask_dead_batch

        o = self.orch
        batch = self.data.batch(self.step_no)
        if self.n_dev > 1:
            batch = mask_dead_batch(batch, o.alive & ~o.quarantined,
                                    self.global_batch, self.n_dev)
        fn, fresh = self._step_fn(o.program, o.grad_scale)
        state = (self.params, self.opt_state, self.ef)
        if check_bitwise:
            ref_prog = build_program(
                dataclasses.replace(o.topo, cap_scale=None), o.blue)
            ref_fn, ref_fresh = self._step_fn(ref_prog, o.grad_scale,
                                              pristine=True)
            fresh = fresh or ref_fresh
            ref = self._run(ref_fn, T.tree_map(_copy, state), batch)
        t0 = time.perf_counter()
        out = self._run(fn, state, batch)
        dt = time.perf_counter() - t0
        params, opt_state, ef, metrics = out
        if check_bitwise:
            _assert_trees_bitwise(
                {"params": params, "opt": opt_state,
                 "loss": metrics["loss"]},
                {"params": ref[0], "opt": ref[1], "loss": ref[3]["loss"]},
                what=f"lossless step {self.step_no} vs fault-free program")
            self.bitwise_checks += 1
        self.params, self.opt_state, self.ef = params, opt_state, ef
        loss = float(metrics["loss"])
        self.losses.append(loss)
        self.step_times.append((dt, fresh))
        self.step_no += 1
        self.steps_run += 1
        if self.mgr is not None and self.step_no % self.ckpt_every == 0:
            self._save()
        return {"loss": loss, "step": self.step_no,
                "step_seconds": dt, "compiled": fresh,
                "bitwise_checked": bool(check_bitwise)}

    def after_event(self, ev: FaultEvent, lossless: bool = False) -> dict:
        """Harness hook: absorb the event, then take one training step."""
        if ev.kind == "crash":
            self.crash_restore()
            info = self.train_step(check_bitwise=False)
            info["restored"] = True
            return info
        return self.train_step(check_bitwise=lossless)

    def summary(self) -> dict:
        times = [t for t, compiled in self.step_times if not compiled]
        return {
            "steps": self.steps_run,
            "first_loss": self.losses[0] if self.losses else None,
            "last_loss": self.losses[-1] if self.losses else None,
            "bitwise_checks": self.bitwise_checks,
            "restores": self.restores,
            "compiles": sum(1 for _, c in self.step_times if c),
            "median_step_seconds": (float(np.median(times)) if times
                                    else None),
        }


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of a state tensor that a step can update in place."""
    return t.detach().clone().requires_grad_(t.requires_grad)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_trees_bitwise(got, want, what: str) -> None:
    """Raise InvariantViolation unless two trees match bit-for-bit."""
    got_l = list(T.leaves_with_paths(got))
    want_l = list(T.leaves_with_paths(want))
    if [p for p, _ in got_l] != [p for p, _ in want_l]:
        raise InvariantViolation(f"{what}: tree structure differs")
    for i, ((_, a), (_, b)) in enumerate(zip(got_l, want_l)):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.shape != b.shape or a.dtype != b.dtype or \
                not torch.equal(_bytes(a), _bytes(b)):
            diff = (float((a.double() - b.double()).abs().max())
                    if a.shape == b.shape else "n/a")
            raise InvariantViolation(
                f"{what}: leaf {i} differs "
                f"(shape {tuple(a.shape)} dtype "
                f"{str(a.dtype).removeprefix('torch.')}; max abs diff "
                f"{diff})")
