"""Fault-tolerant orchestration: failures/stragglers -> SOAR re-placement.

The orchestrator owns the cluster reduction tree, the current blue
placement, and the compiled-in ReduceProgram. Every topology event —
device failure, *switch aggregation-plane failure*, *link-rate
degradation*, straggler quarantine, elastic rescale — funnels into the
same recovery path the paper's model makes cheap:

    update tree/load/Lambda -> SOAR re-sow (O(n h k^2), milliseconds at
    fleet scale) -> rebuild the static reduction program -> resume.

Recovery is *bounded* and comes in two speeds:

  * **degraded mode** (switch failures only): a dead blue switch reverts
    to plain forwarding immediately — the program is rebuilt from the
    surviving blue set with *no* solve, so the utilization regression is
    bounded by that one switch's aggregation saving (never worse than the
    all-red fallback);
  * **preplanned recovery**: what-if placements from ``preplan_failures``
    / ``preplan_switch_failures`` (and every placement the orchestrator
    has already solved) live in a fingerprint-keyed cache. A recovery
    whose post-event topology fingerprint is cached — and whose capacity
    availability still matches the snapshot the entry was solved under —
    is a table lookup, not an engine solve. Hit/miss/stale counters
    surface through :meth:`Orchestrator.preplan_cache_stats`, next to
    the engine's compile-cache telemetry.

The budget k and per-switch aggregation capacity (Sec. 5.2) are respected
across re-placements, so a tenant can never grab more in-network
resources by failing chips or switches.

A copy of the JAX package's ``runtime/orchestrator.py``. Every solve
(``plan``, ``plan_batch``, ``plan_congestion``, ``plan_fleet``) runs the
batched engine on ``options.device``, CUDA unless the orchestrator is
built with ``options=EngineOptions(device="cpu")``; the state the
orchestrator keeps (health masks, link rates, capacity scales, ledgers,
the job registry, the preplan caches) stays numpy on the host, so the
caches key on its bytes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..collectives.schedule import (ReduceProgram, build_program,
                                    plan_batch, plan_congestion, plan_fleet)
from ..collectives.topology import (ClusterTopology, Fleet, degrade_links,
                                    degrade_switches, fail_devices)
from ..core.congestion import measure_fleet, measure_fleet_multi
from ..engine import cache_stats
from ..engine.options import EngineOptions
from .elastic import rescale, scaling_budget
from .stragglers import StragglerPolicy, StragglerReport


def _switch_id(v, n: int, what: str = "switch") -> int:
    """Validate a switch id: integral and in range. ``2.7`` raises instead
    of silently truncating to switch 2."""
    iv = int(v)
    if float(v) != iv:
        raise ValueError(f"{what} id {v!r} is not an integer")
    if not 0 <= iv < n:
        raise ValueError(f"{what} {iv} out of range [0, {n})")
    return iv


@dataclasses.dataclass
class OrchestratorConfig:
    k: int = 4                       # blue-switch budget for this workload
    strategy: str = "soar"           # placement strategy (soar | baselines)
    capacity: int | None = None      # per-switch aggregation capacity a(s)
    straggler_quantile: float = 0.9
    straggler_slack: float = 2.0
    straggler_patience: int = 3


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """One admitted workload's claim on the fleet's capacity ledgers.

    Every admission path files one of these in ``Orchestrator.jobs``, so
    the per-switch conservation invariant — claims + residual ==
    effective capacity — is auditable, and the preemption policies have
    real victims to order. ``benefit`` is the utilization the job's
    in-network aggregation saves vs the all-red fallback (the regression
    preempting it would cost), snapshotted at admission.
    """

    job_id: int
    tree: int                 # fleet tree the claims live on
    blue: np.ndarray          # (n,) bool claim mask (mutated by evictions)
    priority: int             # higher = evicted later
    order: int                # admission sequence number (age)
    utilization: float
    benefit: float


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """Which existing claims to evict when admission cannot fit a wave.

    ``kind`` picks the victim ordering:

    * ``"priority"`` — lowest ``priority`` first (ties: youngest first);
    * ``"youngest-first"`` — most recently admitted first (the classic
      make-room-for-the-old-guard policy);
    * ``"cheapest-regression"`` — smallest aggregation ``benefit`` first,
      so the utilization lost by evicting is minimal.

    ``max_victims`` bounds one admission wave's evictions — preemption
    reuses the two-stage instant-degrade-then-replan shape of
    :meth:`Orchestrator.on_switch_failure`: victims release their claims
    instantly (no solve), then the wave re-solves once against the freed
    ledger.
    """

    kind: str = "priority"
    max_victims: int = 8

    KINDS = ("priority", "youngest-first", "cheapest-regression")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown preemption policy {self.kind!r}; "
                             f"pick one of {self.KINDS}")
        if self.max_victims < 1:
            raise ValueError(f"max_victims must be >= 1, "
                             f"got {self.max_victims}")

    def order_victims(self, jobs: list) -> list:
        """Candidate jobs in eviction order (first = first evicted)."""
        if self.kind == "priority":
            return sorted(jobs, key=lambda j: (j.priority, -j.order))
        if self.kind == "youngest-first":
            return sorted(jobs, key=lambda j: -j.order)
        return sorted(jobs, key=lambda j: (j.benefit, -j.order))


class Orchestrator:
    """Owns topology -> placement -> program; replans on events.

    ``options`` are the engine options of every solve (the device above
    all); the baseline strategies run on the host and take none.
    """

    def __init__(self, topo: ClusterTopology | Fleet,
                 cfg: OrchestratorConfig, *,
                 options: EngineOptions | None = None):
        self.cfg = cfg
        self.options = options
        # the orchestrator's own workload lives on the fleet's first tree;
        # a plain topology is the degenerate single-tree fleet (N=1, no
        # shared core) — one code path, not two
        if isinstance(topo, Fleet):
            self.fleet = topo
            topo = topo.topos[0]
        else:
            self.fleet = Fleet.single(topo)
        self.topo0 = topo
        self.topo = topo
        n = topo.tree.n
        self.alive = np.ones(topo.n_devices, bool)
        self.quarantined = np.zeros(topo.n_devices, bool)
        self.switch_blocked = np.zeros(n, bool)   # dead aggregation planes
        self._link_rate = np.ones(n)              # up-link rate fraction
        self._switch_scale = np.ones(n)           # aggregation-capacity
                                                  # fraction vs pristine
        # residual aggregation capacity (None = unbounded); one ledger per
        # fleet tree — index 0 IS self._residual (same array object)
        self._residual = (np.full(n, cfg.capacity, np.int64)
                          if cfg.capacity is not None else None)
        self._residuals = [self._residual] + [
            np.full(tp.tree.n, cfg.capacity, np.int64)
            if cfg.capacity is not None else None
            for tp in self.fleet.topos[1:]]
        # shared-core rates join every fingerprint: a placement solved
        # against one core pricing must not serve a different one
        self._core_key = self.fleet.core_rho.tobytes()
        self.stragglers = StragglerPolicy(
            topo.n_devices, quantile=cfg.straggler_quantile,
            slack=cfg.straggler_slack, patience=cfg.straggler_patience)
        self.replans = 0
        self.cache_recoveries = 0     # recoveries served without a solve
        self.utilization_history: list[float] = []
        self.degraded_events: list[dict] = []
        self.blue: np.ndarray | None = None
        self.program: ReduceProgram | None = None
        self.last_congestion = None   # CongestionResult of the most recent
                                      # congestion-aware admission
        # multi-job claim registry: every admission path files a JobRecord
        # here (the orchestrator's own workload is NOT a job — it is never
        # preempted); preemption orders its victims out of this registry
        self.jobs: dict[int, JobRecord] = {}
        self._job_seq = 0
        self._allred_util: dict[int, float] = {}   # per-tree baseline cache
        self.preemption_events: list[dict] = []
        self.last_admission: dict | None = None    # telemetry of the most
                                                   # recent begin_workloads
        # device-admission preplan cache: the base fingerprint extended
        # with (count, residual snapshot) — a separate store so the base
        # recovery cache's staleness accounting is untouched
        self._admission_cache: dict = {}
        # preplan cache: topology fingerprint -> solved placement. Filled by
        # preplan_failures / preplan_switch_failures and by every solve the
        # orchestrator performs (revisited states are lookups).
        self._preplan: dict = {}
        self._preplan_stats = {"hits": 0, "misses": 0, "stale": 0}
        self._topo_epoch = 0          # bumped on rescale: old entries die
        self._replace()

    # -- properties ----------------------------------------------------------
    @property
    def n_alive(self) -> int:
        return int((self.alive & ~self.quarantined).sum())

    @property
    def grad_scale(self) -> float:
        """Gradient renormalization: mean over contributing devices."""
        return self.topo0.n_devices / max(1, self.n_alive)

    # -- internal ------------------------------------------------------------
    def _plan(self, topos: list[ClusterTopology], avails: list):
        """``plan_batch`` under this orchestrator's budget and strategy;
        the engine options go only to the soar strategy, which runs the
        engine (``plan_batch`` refuses them for a baseline)."""
        opts = self.options if self.cfg.strategy == "soar" else None
        return plan_batch(topos, self.cfg.k, avails,
                          strategy=self.cfg.strategy, options=opts)

    def _avail(self) -> np.ndarray | None:
        if self._residual is None:
            return None
        return self._residual > 0

    def _replan_avail(self) -> np.ndarray | None:
        """Capacity availability a replan sees: own claim released first."""
        if self._residual is None:
            return None
        r = self._residual.copy()
        if self.blue is not None:
            r[self.blue] += 1
        return r > 0

    def _fingerprint(self, dead: tuple | None = None,
                     blocked: tuple | None = None,
                     link_rate: np.ndarray | None = None,
                     cap_scale: np.ndarray | None = None,
                     tree: int = 0) -> tuple:
        """Hashable key of everything the placement solve depends on:
        the fleet tree id, dead devices, blocked switches, link rates
        (current, or a what-if override), per-switch capacity scales,
        the shared-core rates, budget, strategy, and the topology epoch
        (rescales invalidate everything)."""
        if dead is None:
            dead = tuple(
                np.nonzero(~self.alive | self.quarantined)[0].tolist())
        if blocked is None:
            blocked = tuple(np.nonzero(self.switch_blocked)[0].tolist())
        lr = self._link_rate if link_rate is None else link_rate
        cs = self._switch_scale if cap_scale is None else cap_scale
        return (self._topo_epoch, int(tree), dead, blocked, lr.tobytes(),
                cs.tobytes(), self._core_key, self.cfg.k, self.cfg.strategy)

    def _preplan_store(self, fp: tuple, blue: np.ndarray, util: float,
                       avail: np.ndarray | None) -> None:
        self._preplan[fp] = {
            "blue": np.array(blue, dtype=bool, copy=True),
            "util": float(util),
            # the capacity snapshot the solve ran under; compared at lookup
            # time so a shifted capacity landscape invalidates the entry
            "avail_key": None if avail is None
            else np.asarray(avail, bool).tobytes(),
        }

    def _replace(self) -> None:
        """(Re)compute the SOAR placement + program with an engine solve."""
        if self._residual is not None and self.blue is not None:
            self._residual[self.blue] += 1  # release the old claim
        avail = self._avail()
        self.blue, self.program = self._plan([self.topo], [avail])[0]
        if self._residual is not None:
            self._residual[self.blue] -= 1
        self.replans += 1
        self.utilization_history.append(self.program.utilization)
        # memoize: landing in this exact topology state again (e.g. the
        # mirror recovery of this event) becomes a table lookup
        self._preplan_store(self._fingerprint(), self.blue,
                            self.program.utilization, avail)

    def _apply_cached(self, entry: dict) -> None:
        """Install a preplanned placement: claim swap + program rebuild,
        no engine solve."""
        blue = entry["blue"].copy()
        if self._residual is not None and self.blue is not None:
            self._residual[self.blue] += 1
        program = build_program(self.topo, blue)
        if self._residual is not None:
            self._residual[blue] -= 1
        self.blue = blue
        self.program = program
        self.cache_recoveries += 1
        self.utilization_history.append(program.utilization)

    def _recover(self) -> bool:
        """Cache-or-solve re-placement after a topology event.

        Returns True when the preplan cache served the recovery (no
        engine solve). A cached entry is *stale* — counted, evicted, and
        solved around — when the capacity availability it was computed
        under no longer matches what this replan would see (another
        workload claimed or released switches in the meantime).
        """
        fp = self._fingerprint()
        entry = self._preplan.get(fp)
        if entry is not None:
            avail = self._replan_avail()
            key = None if avail is None else avail.tobytes()
            if key == entry["avail_key"]:
                self._preplan_stats["hits"] += 1
                self._apply_cached(entry)
                return True
            self._preplan_stats["stale"] += 1
            del self._preplan[fp]
        else:
            self._preplan_stats["misses"] += 1
        self._replace()
        return False

    def _scenario_topo(self, dead: list[int],
                       link_rate: np.ndarray | None = None
                       ) -> ClusterTopology:
        """Effective topology for a given dead-device set, with the current
        (or what-if override) link degradations and blocked switches
        applied."""
        lr = self._link_rate if link_rate is None else link_rate
        topo = fail_devices(self.topo0, list(dead))
        if (lr != 1.0).any():
            topo = degrade_links(
                topo, {int(v): float(f)
                       for v, f in enumerate(lr) if f != 1.0})
        if (self._switch_scale != 1.0).any():
            topo = degrade_switches(
                topo, {int(v): float(f)
                       for v, f in enumerate(self._switch_scale)
                       if f != 1.0})
        if self.switch_blocked.any():
            topo = dataclasses.replace(topo,
                                       blocked=self.switch_blocked.copy())
        return topo

    def _effective_topo(self) -> ClusterTopology:
        dead = np.nonzero(~self.alive | self.quarantined)[0]
        return self._scenario_topo(list(dead))

    # -- event handlers -------------------------------------------------------
    def on_failure(self, devices: list[int]) -> ReduceProgram:
        """Hard failure: chips stop producing gradient messages.

        Validates every id before touching any state (and collapses
        duplicates), so a bad id mid-list cannot leave the orchestrator
        half-applied — same discipline as :meth:`on_recover` and
        :func:`~repro_torch.collectives.topology.fail_devices`. Recovery
        goes through the preplan cache (:meth:`preplan_failures`) before
        falling back to an engine solve.
        """
        devices = list(dict.fromkeys(int(d) for d in devices))
        for d in devices:
            if not 0 <= d < len(self.alive):
                raise ValueError(f"device {d} out of range "
                                 f"[0, {len(self.alive)})")
            if not self.alive[d]:
                raise ValueError(f"device {d} already dead")
        # quarantined devices don't count towards n_alive, so only the
        # non-quarantined failures reduce it — reject before mutating
        if sum(1 for d in devices if not self.quarantined[d]) >= self.n_alive:
            raise RuntimeError("all devices failed")
        for d in devices:
            self.alive[d] = False
        self.topo = self._effective_topo()
        self._recover()
        return self.program

    def on_switch_failure(self, switches: list[int]) -> ReduceProgram:
        """A switch's aggregation plane dies; forwarding survives.

        Two-stage recovery (the in-network-computing fault model — P4COM
        handles aggregator loss with a fallback transport the same way):

        1. **degraded mode** — any failed switch that is currently blue
           reverts to plain forwarding *immediately*: its capacity claim
           is released and the program is rebuilt from the surviving blue
           set with no engine solve. The utilization regression is
           bounded — exactly the dead switches' aggregation saving, never
           worse than all-red — and recorded in ``degraded_events``.
        2. **replan** — cache-or-solve through the preplan cache
           (:meth:`preplan_switch_failures` makes step 2 a table lookup
           for every preplanned single-switch failure).
        """
        switches = list(dict.fromkeys(int(s) for s in switches))
        n = self.topo0.tree.n
        for s in switches:
            if not 0 <= s < n:
                raise ValueError(f"switch {s} out of range [0, {n})")
            if self.switch_blocked[s]:
                raise ValueError(f"switch {s} already failed")
        for s in switches:
            self.switch_blocked[s] = True
        self.topo = self._effective_topo()
        degraded_util = None
        was_blue = [s for s in switches
                    if self.blue is not None and self.blue[s]]
        if was_blue:
            deg_blue = self.blue.copy()
            deg_blue[was_blue] = False
            if self._residual is not None:
                self._residual[was_blue] += 1   # dead blues release claims
            self.program = build_program(self.topo, deg_blue)
            self.blue = deg_blue
            degraded_util = self.program.utilization
        hit = self._recover()
        self.degraded_events.append({
            "switches": tuple(switches),
            "was_blue": tuple(was_blue),
            "degraded_utilization": degraded_util,
            "utilization": self.program.utilization,
            "cache_hit": hit,
        })
        return self.program

    def on_switch_recover(self, switches: list[int]) -> ReduceProgram:
        """A repaired aggregation plane rejoins the candidate set."""
        switches = list(dict.fromkeys(int(s) for s in switches))
        n = self.topo0.tree.n
        for s in switches:
            if not 0 <= s < n:
                raise ValueError(f"switch {s} out of range [0, {n})")
            if not self.switch_blocked[s]:
                raise ValueError(f"switch {s} is not failed")
        for s in switches:
            self.switch_blocked[s] = False
        self.topo = self._effective_topo()
        self._recover()
        return self.program

    def _effective_capacity(self, scale: float) -> int:
        """Integer capacity units a switch at ``scale`` still offers."""
        return int(np.floor(self.cfg.capacity * float(scale) + 1e-9))

    def on_switch_degrade(self, scales: dict[int, float]) -> ReduceProgram:
        """Partial aggregation-capacity loss: a(s) shrinks, not to zero.

        ``scales[s]`` is the remaining capacity fraction of switch ``s``
        relative to the *pristine* topology (like :meth:`on_link_degrade`
        semantics: 0.5 = half the aggregation plane left, 1.0 = fully
        recovered; the P4COM/SwitchAgg model where in-network compute is
        a gradually-lost resource). Values are validated — finite, in
        ``[0, 1]``, integral known switch ids — before any state mutates.

        Two-stage recovery, mirroring :meth:`on_switch_failure`:

        1. **degraded mode** — the *current* program is rebuilt instantly
           with no engine solve: the same blue set keeps aggregating at
           the reduced width, spilling its overflow one hop up
           (:func:`~repro_torch.collectives.schedule.build_program` under
           ``cap_scale``), so the utilization regression is bounded by
           the overflow traffic. With a capacity ledger
           (``cfg.capacity``), a switch whose *effective* integer
           capacity ``floor(capacity * scale)`` drops below its live
           claims evicts claims — this workload's own blue first (it
           reverts to forwarding in the instant program), then foreign
           admissions (counted in the event record as
           ``evicted_foreign``); a scale of exactly 0 always forces blue
           off the switch, composing with the blocked/failed semantics.
        2. **replan** — fingerprint-keyed cache-or-solve (the
           fingerprint carries the capacity-scale vector, so restoring a
           previously-seen capacity state is a table lookup).

        Every event is recorded in ``degraded_events`` with the instant
        (degraded) and replanned utilization, the capacity delta, and
        any evictions.
        """
        n = self.topo0.tree.n
        items: list[tuple[int, float]] = []
        for s, f in scales.items():
            s = _switch_id(s, n)
            f = float(f)
            if not np.isfinite(f) or f < 0 or f > 1:
                raise ValueError(f"capacity scale for switch {s} must be "
                                 f"a finite fraction in [0, 1], got {f}")
            items.append((s, f))
        evicted_foreign = 0
        capacity_delta = 0
        dropped_own: list[int] = []
        if self._residual is not None:
            for s, f in items:
                eff_old = self._effective_capacity(self._switch_scale[s])
                eff_new = self._effective_capacity(f)
                capacity_delta += eff_new - eff_old
                claims = eff_old - int(self._residual[s])
                if claims > eff_new:
                    shortfall = claims - eff_new
                    if (shortfall and self.blue is not None
                            and self.blue[s]):
                        dropped_own.append(s)
                        shortfall -= 1
                        claims -= 1
                    evicted_foreign += shortfall
                    claims -= shortfall
                    # keep the job registry consistent with the ledger:
                    # the evicted foreign claims come off the youngest
                    # registered jobs holding s
                    if shortfall:
                        holders = sorted(
                            (j for j in self.jobs.values()
                             if j.tree == 0 and j.blue[s]),
                            key=lambda j: -j.order)
                        for j in holders[:shortfall]:
                            j.blue[s] = False
                self._residual[s] = eff_new - claims
        else:
            # unbounded capacity: only a dead plane (scale 0) forces the
            # workload's blue off — any positive scale still aggregates,
            # at reduced width
            dropped_own = [s for s, f in items
                           if f == 0.0 and self.blue is not None
                           and self.blue[s]]
        for s, f in items:
            self._switch_scale[s] = f
        self.topo = self._effective_topo()
        degraded_util = None
        if self.blue is not None:
            deg_blue = self.blue
            if dropped_own:
                deg_blue = self.blue.copy()
                deg_blue[dropped_own] = False
            # stage 1: instant bounded-regression program — no solve,
            # same (surviving) blues, overflow spilled to parents/hosts
            self.program = build_program(self.topo, deg_blue)
            self.blue = deg_blue
            degraded_util = self.program.utilization
        hit = self._recover()
        self.degraded_events.append({
            "switches": tuple(s for s, _ in items),
            "scales": tuple(f for _, f in items),
            "was_blue": tuple(dropped_own),
            "evicted_foreign": int(evicted_foreign),
            "capacity_delta": int(capacity_delta),
            "degraded_utilization": degraded_util,
            "utilization": self.program.utilization,
            "cache_hit": hit,
        })
        return self.program

    def on_link_degrade(self, rates: dict[int, float]) -> ReduceProgram:
        """Up-link rate changes: re-solve with the updated rho.

        ``rates[v]`` is the remaining rate fraction of switch ``v``'s
        up-link relative to the *pristine* topology (0.5 = half rate,
        1.0 = fully recovered) — the ``rho`` the placement DP optimizes
        over changes, so recovery runs through the normal engine path
        (cache-or-solve; restoring a previously-seen rate state is a
        lookup).
        """
        n = self.topo0.tree.n
        items = [(_switch_id(v, n), float(f)) for v, f in rates.items()]
        for v, f in items:
            if not np.isfinite(f) or f <= 0:
                raise ValueError(f"rate fraction for switch {v} must be a "
                                 f"positive finite number, got {f}")
        for v, f in items:
            self._link_rate[v] = f
        self.topo = self._effective_topo()
        self._recover()
        return self.program

    def on_step_durations(self, durations: np.ndarray) -> StragglerReport:
        """Feed per-device step durations; quarantine persistent stragglers.

        Dead and quarantined devices are masked out of the deadline
        quantile (their EWMA entries are stale and would skew the cutoff)
        and can never be suspects. Refuses to quarantine the last alive
        devices — the same ``n_alive`` floor :meth:`on_failure` enforces,
        but by skipping the quarantine rather than raising (step timings
        are advisory telemetry, not an operator command).
        """
        alive = self.alive & ~self.quarantined
        report = self.stragglers.observe(durations, alive=alive)
        newly = report.quarantined & ~self.quarantined & self.alive
        if newly.any() and int(newly.sum()) < self.n_alive:
            self.quarantined |= newly
            self.topo = self._effective_topo()
            self._recover()
        return report

    def on_recover(self, devices: list[int]) -> ReduceProgram:
        """A replaced/recovered chip rejoins the reduction tree.

        Only devices that are actually failed or quarantined can recover —
        symmetric with :meth:`on_failure`'s already-dead check. Validation
        runs before any state is touched, so a bad id in the middle of the
        list cannot leave a half-applied recovery.
        """
        for d in devices:
            if not 0 <= d < len(self.alive):
                raise ValueError(f"device {d} out of range "
                                 f"[0, {len(self.alive)})")
            if self.alive[d] and not self.quarantined[d]:
                raise ValueError(f"device {d} is not failed or quarantined")
        for d in devices:
            self.alive[d] = True
            self.quarantined[d] = False
            self.stragglers.clear(d)
        self.topo = self._effective_topo()
        self._recover()
        return self.program

    def on_rescale(self, n_pods: int | None = None,
                   racks_per_pod: int | None = None,
                   chips_per_rack: int | None = None,
                   budget_policy: str = "proportional") -> ReduceProgram:
        """Elastic rescale: drain -> rebuild the fleet -> re-sow the budget.

        The fleet tree is rebuilt at the new dimensions (unspecified ones
        keep their current value, see :func:`repro_torch.runtime.
        elastic.rescale`), the blue budget moves per
        :func:`~repro_torch.runtime.elastic.scaling_budget`, and this workload
        is re-placed through the normal claim accounting. Rescaling
        drains the fleet: other workloads' capacity claims are dropped
        (re-admit them via :meth:`begin_workloads`), and device health,
        straggler state and the preplan cache reset with the topology.
        """
        old_devices = self.topo0.n_devices
        new_topo = rescale(self.topo0, n_pods=n_pods,
                           racks_per_pod=racks_per_pod,
                           chips_per_rack=chips_per_rack)
        self.cfg = dataclasses.replace(
            self.cfg, k=scaling_budget(self.cfg.k, old_devices,
                                       new_topo.n_devices, budget_policy))
        n = new_topo.tree.n
        self.topo0 = new_topo
        self.topo = new_topo
        self.fleet = Fleet.single(new_topo)   # rescale drains fleet trees
        self._core_key = self.fleet.core_rho.tobytes()
        self.alive = np.ones(new_topo.n_devices, bool)
        self.quarantined = np.zeros(new_topo.n_devices, bool)
        self.switch_blocked = np.zeros(n, bool)
        self._link_rate = np.ones(n)
        self._switch_scale = np.ones(n)
        self._residual = (np.full(n, self.cfg.capacity, np.int64)
                          if self.cfg.capacity is not None else None)
        self._residuals = [self._residual]
        self.jobs.clear()             # rescale drains every foreign claim
        self._allred_util.clear()
        self._admission_cache.clear()
        self.stragglers = StragglerPolicy(
            new_topo.n_devices, quantile=self.cfg.straggler_quantile,
            slack=self.cfg.straggler_slack,
            patience=self.cfg.straggler_patience)
        self.blue = None
        self._topo_epoch += 1
        self._preplan.clear()
        self._replace()
        return self.program

    # -- multi-job admission --------------------------------------------------
    def _register_job(self, blue: np.ndarray, prog: ReduceProgram,
                      tree: int = 0, priority: int = 0) -> JobRecord:
        """File an admitted workload's claims in the job registry."""
        base = self._allred_util.get(tree)
        if base is None:
            tp = self.fleet.topos[tree]
            base = build_program(
                tp, np.zeros(tp.tree.n, bool)).utilization
            self._allred_util[tree] = base
        self._job_seq += 1
        rec = JobRecord(
            job_id=self._job_seq, tree=int(tree),
            blue=np.array(blue, dtype=bool, copy=True),
            priority=int(priority), order=self._job_seq,
            utilization=float(prog.utilization),
            benefit=float(base - prog.utilization))
        self.jobs[rec.job_id] = rec
        return rec

    def release_workloads(self, job_ids) -> int:
        """Release admitted jobs' capacity claims; returns claims freed."""
        freed = 0
        for jid in job_ids:
            j = self.jobs.pop(int(jid), None)
            if j is None:
                raise KeyError(f"unknown job id {jid}")
            self._residuals[j.tree][j.blue] += 1
            freed += int(j.blue.sum())
        return freed

    def _preempt(self, policy: PreemptionPolicy, res) -> tuple[list, int]:
        """Stage 1 of preemptive admission: evict registered jobs holding
        claims on the switches the failed wave exhausted (instant — no
        solve; the caller re-solves once against the freed ledger).
        Returns ``(victim job ids, claims freed on exhausted switches)``.
        """
        scarce = [np.asarray(ra) == 0 for ra in res.residual_after]
        shortfall = int(np.asarray(res.admission_dropped).sum())
        cands = [j for j in self.jobs.values()
                 if j.tree < len(scarce) and np.any(j.blue & scarce[j.tree])]
        victims: list[int] = []
        freed = 0
        for j in policy.order_victims(cands):
            if freed >= shortfall or len(victims) >= policy.max_victims:
                break
            self._residuals[j.tree][j.blue] += 1
            freed += int((j.blue & scarce[j.tree]).sum())
            victims.append(j.job_id)
            del self.jobs[j.job_id]
        return victims, freed

    def begin_workload(self, priority: int = 0) -> ReduceProgram:
        """Multi-workload mode (Sec. 5.2): claim capacity for a new workload.

        The previous workload keeps its claim; the new one sees only
        switches with residual capacity.
        """
        if self._residual is None:
            raise ValueError("begin_workload needs capacity set")
        blue, prog = self._plan([self.topo], [self._avail()])[0]
        self._residual[blue] -= 1
        self.utilization_history.append(prog.utilization)
        self._register_job(blue, prog, priority=priority)
        return prog

    def begin_workloads(self, count: int | None = None,
                        congestion_aware: bool = False,
                        capacity_priced: bool = False,
                        fleet: list[int] | None = None,
                        device_admission: bool = False,
                        preemption: PreemptionPolicy | None = None,
                        priority: int = 0,
                        **driver_kw) -> list[ReduceProgram]:
        """Admit ``count`` workloads with one batched engine solve.

        All instances are solved against the *current* availability
        snapshot in a single :func:`repro_torch.engine.solve_batch` call;
        claims are then applied in order, and any workload whose placement
        touched a switch that ran out of capacity in the meantime is
        re-solved serially against the updated availability (rare — it
        needs ``count`` placements to pile onto one switch's last slots).

        ``congestion_aware=True`` routes admission through the
        repeated-solve congestion driver
        (:func:`repro_torch.collectives.schedule.plan_congestion`): the
        batch is re-solved under penalty-reweighted link rates until the
        max-link congestion across the admitted tenants stops improving,
        then the same capacity claim/collision accounting applies. The driver's
        diagnostics land in ``self.last_congestion`` (re-measured against
        the *admitted* placements when collision fallbacks replaced any
        driver placement, so it never overstates the fleet); extra keyword
        arguments (``max_rounds``, ``alpha``, ``rho_weighted``,
        ``device_loop``, …) pass through to it. Requires
        ``strategy="soar"``.

        ``capacity_priced=True`` (congestion-aware only) additionally
        hands the driver the orchestrator's *residual capacity snapshot*
        as its capacity-pricing signal: switches this admission wave is
        about to exhaust get priced up inside the penalty loop, steering
        tenants away *before* the claim accounting collides — fewer
        serial collision fallbacks, same bounded-capacity guarantee.

        ``fleet=[c_0, .., c_{N-1}]`` (instead of ``count``) admits
        ``c_g`` workloads onto tree ``g`` of the orchestrator's
        :class:`~repro_torch.collectives.topology.Fleet` with one
        *coupled* :func:`~repro_torch.collectives.schedule.plan_fleet`
        solve — tenants on different trees trade placements through the
        fleet's shared core links — and per-tree capacity claims: each
        tenant claims against its own tree's residual ledger, collision
        fallbacks re-solve on the tenant's own tree only. Requires
        ``congestion_aware=True`` (fleet admission *is* the congestion
        driver); a plain-topology orchestrator accepts ``fleet=[c]`` as
        the degenerate N=1 case.

        ``device_admission=True`` (congestion-aware only) moves the hard
        admission *inside* the device-resident penalty loop: the solver
        gets this orchestrator's residual ledger(s) as the engine's
        ``residual=`` constraint, so the returned placements are feasible
        wholesale — claims apply with **zero** collision fallbacks and
        zero extra host↔device round trips. When the wave still cannot
        fit (the loop reports dropped claims), a :class:`PreemptionPolicy`
        passed as ``preemption=`` evicts existing jobs from the exhausted
        switches (instantly, no solve) and re-solves once. Telemetry of
        every wave lands in ``self.last_admission``.
        """
        if self._residual is None:
            raise ValueError("begin_workloads needs capacity set")
        if congestion_aware and self.cfg.strategy != "soar":
            raise ValueError("congestion-aware admission needs "
                             f"strategy='soar', not {self.cfg.strategy!r}")
        if not congestion_aware and (driver_kw or capacity_priced
                                     or device_admission):
            what = (sorted(driver_kw) if driver_kw else
                    "device_admission" if device_admission
                    else "capacity_priced")
            raise ValueError(f"driver options {what} only "
                             "apply with congestion_aware=True")
        if preemption is not None and not device_admission:
            raise ValueError("preemption= needs device_admission=True — "
                             "only the in-loop admission path reports the "
                             "shortfall preemption resolves")
        if device_admission and "residual" in driver_kw:
            raise ValueError("device_admission=True supplies the "
                             "orchestrator's residual ledger; don't also "
                             "pass residual= explicitly")
        if (count is None) == (fleet is None):
            raise ValueError("pass exactly one of count / fleet")
        if fleet is not None:
            if not congestion_aware:
                raise ValueError("fleet admission is congestion-coupled; "
                                 "pass congestion_aware=True")
            return self._begin_fleet_workloads(
                [int(c) for c in fleet], capacity_priced, driver_kw,
                device_admission=device_admission, preemption=preemption,
                priority=priority)
        if capacity_priced:
            if "capacity" in driver_kw:
                raise ValueError("capacity_priced=True supplies the "
                                 "orchestrator's residual-capacity snapshot; "
                                 "don't also pass capacity= explicitly")
            driver_kw = dict(driver_kw,
                             capacity=self._residual.astype(np.float64))
        if count == 0:
            return []
        if device_admission:
            return self._begin_device_admission(count, preemption, priority,
                                                driver_kw)
        snapshot = self._avail()
        driver_res = None
        if congestion_aware:
            planned, driver_res = plan_congestion(
                self.topo, self.cfg.k, count=count, avails=snapshot,
                options=self.options, **driver_kw)
        else:
            planned = self._plan([self.topo] * count, [snapshot] * count)
        progs: list[ReduceProgram] = []
        admitted: list[np.ndarray] = []
        collisions = 0
        for blue, prog in planned:
            if np.any(blue & (self._residual <= 0)):   # capacity collision
                blue, prog = self._plan([self.topo], [self._avail()])[0]
                collisions += 1
            self._residual[blue] -= 1
            self.utilization_history.append(prog.utilization)
            self._register_job(blue, prog, priority=priority)
            progs.append(prog)
            admitted.append(blue)
        # each collision fallback is one extra host-side solve round trip
        # on top of the wave's batched solve
        self.last_admission = {
            "path": "host", "solves": 1 + collisions,
            "round_trips": 1 + collisions, "collisions": collisions,
            "dropped": 0, "preempted": (), "cache_hit": False}
        if driver_res is not None:
            # collision fallbacks replace driver placements with
            # utilization-only ones; re-measure so last_congestion reports
            # what was actually admitted, not what the driver proposed
            if collisions:
                m = measure_fleet(
                    self.topo.tree, [self.topo.load] * count, admitted,
                    rho_weighted=driver_kw.get("rho_weighted", False))
                driver_res = dataclasses.replace(
                    driver_res, blue=np.stack(admitted), costs=m.costs,
                    msgs=m.msgs, congestion=m.congestion,
                    max_congestion=m.max_congestion,
                    mean_congestion=m.mean_congestion)
            self.last_congestion = driver_res
        return progs

    def _begin_device_admission(self, count: int,
                                preemption: PreemptionPolicy | None,
                                priority: int,
                                driver_kw: dict) -> list[ReduceProgram]:
        """Admission with the hard claim ledger *inside* the penalty loop.

        One coupled solve returns placements already feasible against
        ``self._residual`` — claims apply with zero collision fallbacks.
        A wave the ledger cannot fit triggers at most one preemption pass
        (policy-ordered evictions, then a single re-solve). Waves with no
        extra driver knobs and no preemption are served from the
        admission preplan cache when the exact (count, residual,
        fingerprint) state recurs — zero solves, zero round trips.
        """
        cacheable = not driver_kw and preemption is None
        key = ("admit", int(count), self._residual.tobytes(),
               self._fingerprint())
        if cacheable:
            entry = self._admission_cache.get(key)
            if entry is not None:
                progs = []
                for blue in entry["blues"]:
                    prog = build_program(self.topo, blue)
                    self._residual[blue] -= 1
                    self.utilization_history.append(prog.utilization)
                    self._register_job(blue, prog, priority=priority)
                    progs.append(prog)
                self.cache_recoveries += 1
                self.last_admission = {
                    "path": "device", "solves": 0, "round_trips": 0,
                    "collisions": 0, "dropped": 0, "preempted": (),
                    "cache_hit": True}
                return progs
        solves = 0
        victims: list[int] = []
        while True:
            planned, res = plan_congestion(
                self.topo, self.cfg.k, count=count, avails=self._avail(),
                residual=self._residual.copy(), options=self.options,
                **driver_kw)
            solves += 1
            dropped = int(np.asarray(res.admission_dropped).sum())
            if dropped == 0 or preemption is None or solves > 1:
                break
            evicted, freed = self._preempt(preemption, res)
            if not evicted:
                break
            victims.extend(evicted)
            self.preemption_events.append({
                "policy": preemption.kind, "victims": tuple(evicted),
                "freed": int(freed), "dropped_before": dropped})
        progs: list[ReduceProgram] = []
        for blue, prog in planned:
            self._residual[blue] -= 1
            self.utilization_history.append(prog.utilization)
            self._register_job(blue, prog, priority=priority)
            progs.append(prog)
        if np.any(self._residual < 0):
            raise RuntimeError("in-loop admission returned an infeasible "
                               "placement — engine/ledger disagreement")
        self.last_congestion = res
        self.last_admission = {
            "path": "device", "solves": solves, "round_trips": solves,
            "collisions": 0, "dropped": dropped,
            "preempted": tuple(victims), "cache_hit": False}
        if cacheable and dropped == 0 and not victims:
            self._admission_cache[key] = {
                "blues": [np.array(b, dtype=bool, copy=True)
                          for b, _ in planned]}
        return progs

    def _begin_fleet_workloads(self, counts: list[int],
                               capacity_priced: bool,
                               driver_kw: dict,
                               device_admission: bool = False,
                               preemption: PreemptionPolicy | None = None,
                               priority: int = 0) -> list[ReduceProgram]:
        """Fleet admission: one coupled solve, per-tree capacity claims."""
        N = self.fleet.n_trees
        if len(counts) != N or any(c < 1 for c in counts):
            raise ValueError(f"fleet counts must give >=1 workloads for "
                             f"each of the {N} trees, got {counts}")
        if capacity_priced:
            if "capacity" in driver_kw:
                raise ValueError("capacity_priced=True supplies the "
                                 "orchestrator's residual-capacity snapshot; "
                                 "don't also pass capacity= explicitly")
            driver_kw = dict(driver_kw, capacity=[
                r.astype(np.float64) for r in self._residuals])
        tree_of = [g for g, c in enumerate(counts) for _ in range(c)]
        if device_admission:
            return self._begin_fleet_device(counts, tree_of, preemption,
                                            priority, driver_kw)
        snaps = [r > 0 for r in self._residuals]
        planned, driver_res = plan_fleet(
            self.fleet, self.cfg.k, counts=counts,
            avails=[snaps[g] for g in tree_of], options=self.options,
            **driver_kw)
        progs: list[ReduceProgram] = []
        admitted: list[np.ndarray] = []
        collisions = 0
        for g, (blue, prog) in zip(tree_of, planned, strict=True):
            res_g = self._residuals[g]
            if np.any(blue & (res_g <= 0)):        # capacity collision
                blue, prog = self._plan([self.fleet.topos[g]],
                                        [res_g > 0])[0]
                collisions += 1
            res_g[blue] -= 1                       # this tree's ledger
            self.utilization_history.append(prog.utilization)
            self._register_job(blue, prog, tree=g, priority=priority)
            progs.append(prog)
            admitted.append(blue)
        self.last_admission = {
            "path": "host", "solves": 1 + collisions,
            "round_trips": 1 + collisions, "collisions": collisions,
            "dropped": 0, "preempted": (), "cache_hit": False}
        if collisions:
            # re-measure against the admitted placements (collision
            # fallbacks replaced driver ones) — global link-id space,
            # shared core included, so last_congestion never overstates
            trees = [tp.tree for tp in self.fleet.topos]
            loads = [self.fleet.topos[g].load for g in tree_of]
            has_core = self.fleet.n_core > 0
            m = measure_fleet_multi(
                trees, tree_of, loads, admitted,
                core_rho=self.fleet.core_rho if has_core else None,
                core_path=self.fleet.core_path if has_core else None,
                rho_weighted=driver_kw.get("rho_weighted", False))
            n_big = max(t.n for t in trees)
            stack = np.zeros((len(admitted), n_big), bool)
            for t, b in enumerate(admitted):
                stack[t, : b.size] = b
            driver_res = dataclasses.replace(
                driver_res, blue=stack, costs=m.costs, msgs=m.msgs,
                congestion=m.congestion, max_congestion=m.max_congestion,
                mean_congestion=m.mean_congestion,
                core_congestion=m.core_congestion)
        self.last_congestion = driver_res
        return progs

    def _begin_fleet_device(self, counts: list[int], tree_of: list[int],
                            preemption: PreemptionPolicy | None,
                            priority: int,
                            driver_kw: dict) -> list[ReduceProgram]:
        """Fleet admission with per-tree ledgers inside the loop — the
        multi-tree twin of :meth:`_begin_device_admission` (no collision
        fallbacks; at most one preemption pass)."""
        solves = 0
        victims: list[int] = []
        while True:
            snaps = [r > 0 for r in self._residuals]
            planned, res = plan_fleet(
                self.fleet, self.cfg.k, counts=counts,
                avails=[snaps[g] for g in tree_of],
                residual=[r.copy() for r in self._residuals],
                options=self.options, **driver_kw)
            solves += 1
            dropped = int(np.asarray(res.admission_dropped).sum())
            if dropped == 0 or preemption is None or solves > 1:
                break
            evicted, freed = self._preempt(preemption, res)
            if not evicted:
                break
            victims.extend(evicted)
            self.preemption_events.append({
                "policy": preemption.kind, "victims": tuple(evicted),
                "freed": int(freed), "dropped_before": dropped})
        progs: list[ReduceProgram] = []
        for g, (blue, prog) in zip(tree_of, planned, strict=True):
            self._residuals[g][blue] -= 1
            self.utilization_history.append(prog.utilization)
            self._register_job(blue, prog, tree=g, priority=priority)
            progs.append(prog)
        if any(np.any(r < 0) for r in self._residuals):
            raise RuntimeError("in-loop fleet admission returned an "
                               "infeasible placement — engine/ledger "
                               "disagreement")
        self.last_congestion = res
        self.last_admission = {
            "path": "device", "solves": solves, "round_trips": solves,
            "collisions": 0, "dropped": dropped,
            "preempted": tuple(victims), "cache_hit": False}
        return progs

    # -- telemetry ------------------------------------------------------------
    def preplan_cache_stats(self) -> dict:
        """Preplan-cache telemetry: lookup hits / misses / stale entries,
        current entry count, and recoveries served without a solve."""
        return {**self._preplan_stats, "entries": len(self._preplan),
                "cache_recoveries": self.cache_recoveries}

    def engine_cache_stats(self) -> dict:
        """Placement-engine kernel/packing cache telemetry.

        The engine's :func:`repro_torch.engine.cache_stats`: the CUDA
        kernel entry points loaded (``kernels_built``) and the Forest
        packing counts (``forests_built``, ``distinct_layouts``), so
        operators can see that steady-state serving repacks no new
        layouts. The ``preplan`` sub-dict reports the recovery preplan
        cache (:meth:`preplan_cache_stats`) next to them.
        """
        return {**cache_stats(), "preplan": self.preplan_cache_stats()}

    # -- what-if preplanning --------------------------------------------------
    def preplan_failures(
        self, failure_sets: list[list[int]]
    ) -> list[tuple[np.ndarray, float]]:
        """What-if analysis: SOAR placements for hypothetical failures.

        Builds the effective topology of every scenario and solves them
        all in one batched engine call (same tree shape -> one compiled
        executable; the device-resident solve returns just the masks and
        costs). Returns ``[(blue, utilization)]`` per scenario, and files
        every result in the preplan cache so the matching *real* failure
        recovers with a table lookup instead of a solve (entries go stale
        — and fall back to solving — if the capacity landscape shifts
        before the failure happens).
        """
        topos, fps = [], []
        for devices in failure_sets:
            dead = set(np.nonzero(~self.alive | self.quarantined)[0].tolist())
            dead.update(int(d) for d in devices)
            dead = sorted(dead)
            topos.append(self._scenario_topo(dead))
            fps.append(self._fingerprint(dead=tuple(dead)))
        # a real failure replan releases this workload's own claim before
        # re-placing; mirror that, or preplans would see fewer available
        # switches than recovery actually has
        avail = self._replan_avail()
        planned = self._plan(topos, [avail] * len(topos))
        out = []
        for fp, (blue, prog) in zip(fps, planned):
            self._preplan_store(fp, blue, prog.utilization, avail)
            out.append((blue, prog.utilization))
        return out

    def preplan_link_degrades(
        self, rate_sets: list[dict[int, float]] | None = None,
        factor: float = 0.5,
    ) -> list[tuple[np.ndarray, float]]:
        """What-if analysis for link-rate degradations.

        By default preplans every currently-undegraded switch's up-link
        dropping to ``factor`` of its pristine rate, alone — the
        single-link brownouts that dominate real degradation traffic —
        in one batched engine call; pass explicit ``rate_sets`` (each a
        ``{switch: fraction}`` dict, fractions relative to the pristine
        topology like :meth:`on_link_degrade`) for correlated scenarios.
        Results are returned as ``[(blue, utilization)]`` and filed in
        the preplan cache keyed by the post-degrade fingerprint (link
        rates are already part of every key), so the matching real
        :meth:`on_link_degrade` recovers with a table lookup instead of
        a solve — bit-identical to what a fresh solve would place, and
        subject to the same capacity-drift staleness eviction as
        :meth:`preplan_failures` / :meth:`preplan_switch_failures`.
        """
        n = self.topo0.tree.n
        if rate_sets is None:
            if not np.isfinite(factor) or not 0 < factor:
                raise ValueError(f"rate fraction must be a positive finite "
                                 f"number, got {factor}")
            rate_sets = [{int(v): float(factor)} for v in range(n)
                         if self._link_rate[v] == 1.0]
        dead_now = sorted(
            np.nonzero(~self.alive | self.quarantined)[0].tolist())
        topos, fps = [], []
        for rates in rate_sets:
            items = [(int(v), float(f)) for v, f in rates.items()]
            for v, f in items:
                if not 0 <= v < n:
                    raise ValueError(f"switch {v} out of range [0, {n})")
                if not np.isfinite(f) or f <= 0:
                    raise ValueError(f"rate fraction for switch {v} must "
                                     f"be a positive finite number, got {f}")
            lr = self._link_rate.copy()
            for v, f in items:
                lr[v] = f
            topos.append(self._scenario_topo(dead_now, link_rate=lr))
            fps.append(self._fingerprint(link_rate=lr))
        avail = self._replan_avail()
        planned = self._plan(topos, [avail] * len(topos))
        out = []
        for fp, (blue, prog) in zip(fps, planned):
            self._preplan_store(fp, blue, prog.utilization, avail)
            out.append((blue, prog.utilization))
        return out

    def preplan_switch_failures(
        self, switch_sets: list[list[int]] | None = None
    ) -> list[tuple[np.ndarray, float]]:
        """What-if analysis for aggregation-plane failures.

        By default preplans every currently-available switch failing
        alone — the single-switch scenarios that dominate real recovery
        traffic — in one batched engine call; pass explicit ``switch_sets``
        for correlated scenarios. Results are returned as
        ``[(blue, utilization)]`` and filed in the preplan cache keyed by
        the post-failure topology fingerprint, so
        :meth:`on_switch_failure` recovers those scenarios without a
        solve (staleness rules as in :meth:`preplan_failures`).
        """
        n = self.topo0.tree.n
        if switch_sets is None:
            switch_sets = [[int(s)]
                           for s in np.nonzero(~self.switch_blocked)[0]]
        dead_now = sorted(
            np.nonzero(~self.alive | self.quarantined)[0].tolist())
        base = self._scenario_topo(dead_now)
        topos, fps = [], []
        for switches in switch_sets:
            blocked = self.switch_blocked.copy()
            for s in switches:
                s = int(s)
                if not 0 <= s < n:
                    raise ValueError(f"switch {s} out of range [0, {n})")
                blocked[s] = True
            topos.append(dataclasses.replace(base, blocked=blocked))
            fps.append(self._fingerprint(
                blocked=tuple(np.nonzero(blocked)[0].tolist())))
        avail = self._replan_avail()
        planned = self._plan(topos, [avail] * len(topos))
        out = []
        for fp, (blue, prog) in zip(fps, planned):
            self._preplan_store(fp, blue, prog.utilization, avail)
            out.append((blue, prog.utilization))
        return out
