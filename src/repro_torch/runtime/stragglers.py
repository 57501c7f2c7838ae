"""Straggler detection and mitigation for the SOAR reduction pipeline.

A copy of the JAX package's ``runtime/stragglers.py``: host telemetry in
numpy (the deadline is ``np.quantile`` over the alive profile, whose
interpolation a torch quantile would not repeat).

A blue (aggregating) switch *waits* for all children before emitting its
message (paper Sec. 4.4: aggregating nodes hold until all inputs arrive),
so a single slow device stalls every barrier on its root path — straggling
is strictly more harmful under in-network aggregation than under
store-and-forward. The policy here is the standard production recipe:

  * per-step device durations are folded into an EWMA profile;
  * a device is a *suspect* when its duration exceeds
    ``deadline = quantile(durations, q) * slack``;
  * persistent suspects (``patience`` consecutive suspect steps) are
    *quarantined*: the orchestrator treats them as failed for placement
    purposes (drop-from-reduce with gradient renormalization) until they
    recover or are replaced.

Quarantine feeds back into SOAR: the reduction tree loses the quarantined
chip's load, and the budget is re-sown over the remaining topology.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    suspects: np.ndarray       # (n_dev,) bool — slow this step
    quarantined: np.ndarray    # (n_dev,) bool — persistently slow
    deadline: float            # the step's cut-off in seconds


class StragglerPolicy:
    """Deadline + patience straggler tracker."""

    def __init__(self, n_devices: int, quantile: float = 0.9,
                 slack: float = 2.0, patience: int = 3,
                 ewma: float = 0.5):
        if not 0.0 < quantile < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        if slack < 1.0:
            raise ValueError("slack must be >= 1")
        self.quantile = quantile
        self.slack = slack
        self.patience = patience
        self.ewma = ewma
        self._profile = np.zeros(n_devices)
        self._strikes = np.zeros(n_devices, np.int64)
        self._observed = np.zeros(n_devices, bool)

    def observe(self, durations: np.ndarray,
                alive: np.ndarray | None = None) -> StragglerReport:
        """Fold one step's per-device durations; return suspects/quarantine.

        ``alive`` masks the devices that actually ran this step: dead or
        quarantined devices keep their (stale) EWMA entries but are
        excluded from the deadline quantile — otherwise a dead slow
        device's frozen profile inflates the cutoff forever and live
        stragglers sail under it — and can never be suspects.
        """
        d = np.asarray(durations, dtype=np.float64)
        if d.shape != self._profile.shape:
            raise ValueError(f"expected {self._profile.shape}, got {d.shape}")
        if alive is None:
            alive = np.ones_like(self._profile, dtype=bool)
        else:
            alive = np.asarray(alive, dtype=bool)
            if alive.shape != self._profile.shape:
                raise ValueError(f"expected alive mask {self._profile.shape},"
                                 f" got {alive.shape}")
        first = alive & ~self._observed
        folded = self.ewma * d + (1 - self.ewma) * self._profile
        self._profile = np.where(first, d,
                                 np.where(alive, folded, self._profile))
        self._observed |= alive
        if alive.any():
            deadline = float(
                np.quantile(self._profile[alive], self.quantile)) * self.slack
            suspects = alive & (self._profile > deadline)
        else:
            deadline = float("inf")
            suspects = np.zeros_like(alive)
        self._strikes = np.where(suspects, self._strikes + 1, 0)
        return StragglerReport(
            suspects=suspects,
            quarantined=self._strikes >= self.patience,
            deadline=deadline,
        )

    def clear(self, device: int) -> None:
        """Forget history for a replaced/recovered device."""
        self._strikes[device] = 0
        ref = self._profile[self._observed]
        self._profile[device] = float(np.median(ref)) if len(ref) else 0.0
        self._observed[device] = True
