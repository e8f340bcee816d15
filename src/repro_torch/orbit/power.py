"""Orbit power model: sunlit/eclipse phases and the global energy bucket
(the port's copy of ``repro.orbit.power``).

A spacecraft's electrical budget is an *orbit-average* constraint: the
solar array harvests during sunlit phases, the battery rides through
eclipse, and the payload must shape its load so the battery never runs
dry.  Two pieces model that here, entirely on the fleet's deterministic
virtual clock (no wall time — the same profile prices a test, a
benchmark, and a launcher run identically):

* :class:`PowerProfile` — a cyclic sequence of :class:`OrbitPhase`
  entries (name, duration, harvested watts).  ``energy_between(t0, t1)``
  integrates the harvest over any interval, handling partial phases and
  whole orbits in O(phases).
* :class:`EnergyBucket` — the battery as a token bucket: ``advance(now)``
  banks the profile's harvest since the last call (clipped at capacity),
  ``drain(j)`` spends against it (clipped at zero — the level is never
  negative; spend beyond the level is recorded as ``shortfall_j``, the
  quantity an uncontrolled fleet would have overdrawn).

The :class:`~repro_torch.orbit.controller.FleetController` drains the bucket
with the fleet's telemetry ``energy_j`` deltas and keys its dispatch
mode off ``frac`` — that is the whole coupling between orbit mechanics
and the router.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass(frozen=True)
class OrbitPhase:
    """One leg of the orbit's power cycle."""
    name: str
    duration_s: float
    power_w: float

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"phase {self.name!r}: duration must be > 0")
        if self.power_w < 0:
            raise ValueError(f"phase {self.name!r}: power must be >= 0")


class PowerProfile:
    """Cyclic harvested-power profile on the fleet's virtual clock."""

    def __init__(self, phases: Sequence[OrbitPhase]):
        if not phases:
            raise ValueError("a power profile needs at least one phase")
        self.phases: Tuple[OrbitPhase, ...] = tuple(phases)
        self.period_s = sum(p.duration_s for p in self.phases)
        # prefix sums: phase start offsets and cumulative energy, so any
        # within-cycle integral is two lookups + one partial phase
        self._starts = [0.0]
        self._cum_j = [0.0]
        for p in self.phases:
            self._starts.append(self._starts[-1] + p.duration_s)
            self._cum_j.append(self._cum_j[-1] + p.duration_s * p.power_w)
        self.cycle_j = self._cum_j[-1]

    @property
    def orbit_average_w(self) -> float:
        """The long-run harvest rate — the fleet's sustainable draw."""
        return self.cycle_j / self.period_s

    def phase_at(self, t: float) -> OrbitPhase:
        tau = t % self.period_s
        for start, p in zip(self._starts, self.phases):
            if tau < start + p.duration_s:
                return p
        return self.phases[-1]          # tau == period_s boundary

    def power_at(self, t: float) -> float:
        return self.phase_at(t).power_w

    def _cycle_energy_to(self, tau: float) -> float:
        """Integral of power over [0, tau] for tau within one period."""
        for i, p in enumerate(self.phases):
            if tau <= self._starts[i + 1]:
                return self._cum_j[i] + (tau - self._starts[i]) * p.power_w
        return self.cycle_j

    def energy_between(self, t0: float, t1: float) -> float:
        """Harvested joules over [t0, t1] (t1 >= t0)."""
        if t1 <= t0:
            return 0.0
        cycles, tau0 = divmod(t0, self.period_s)
        span = t1 - t0
        full, rem = divmod(span, self.period_s)
        e = full * self.cycle_j
        tau1 = tau0 + rem
        if tau1 <= self.period_s:
            e += self._cycle_energy_to(tau1) - self._cycle_energy_to(tau0)
        else:
            e += (self.cycle_j - self._cycle_energy_to(tau0)
                  + self._cycle_energy_to(tau1 - self.period_s))
        return e


class EnergyBucket:
    """The battery as a token bucket over the fleet's energy telemetry.

    Invariant (property-tested): ``0 <= level_j <= capacity_j`` after any
    interleaving of ``advance`` and ``drain`` calls.  Harvest beyond a
    full bucket is counted as ``wasted_j``; spend beyond the level is
    counted as ``shortfall_j`` (the overdraw an uncapped fleet would have
    taken out of the orbit-average budget).
    """

    def __init__(self, capacity_j: float, profile: PowerProfile = None,
                 level_j: float = None, t0: float = 0.0):
        if capacity_j <= 0:
            raise ValueError("bucket capacity must be > 0")
        self.capacity_j = capacity_j
        self.profile = profile
        self.level_j = (capacity_j if level_j is None
                        else min(max(level_j, 0.0), capacity_j))
        self._t = t0
        self.harvested_j = 0.0          # raw profile integral seen so far
        self.wasted_j = 0.0             # harvest clipped by a full bucket
        self.spent_j = 0.0              # total drain requested
        self.shortfall_j = 0.0          # drain requested beyond the level

    @property
    def frac(self) -> float:
        return self.level_j / self.capacity_j

    def rebase(self, now: float) -> None:
        """Move the harvest clock forward to ``now`` without banking the
        skipped interval — attaching a controller to a fleet that has
        already been running must not credit phantom pre-attach
        harvest."""
        self._t = max(self._t, now)

    def advance(self, now: float) -> float:
        """Bank the profile's harvest since the last call; returns the
        joules actually added (post-clip)."""
        if self.profile is None or now <= self._t:
            return 0.0
        e = self.profile.energy_between(self._t, now)
        self._t = now
        take = min(e, self.capacity_j - self.level_j)
        self.level_j += take
        self.harvested_j += e
        self.wasted_j += e - take
        return take

    def drain(self, joules: float) -> float:
        """Spend against the bucket; returns the joules actually covered.
        The level clips at zero — never negative."""
        if joules <= 0:
            return 0.0
        take = min(joules, self.level_j)
        self.level_j -= take
        self.spent_j += joules
        self.shortfall_j += joules - take
        return take

    def refund(self, joules: float) -> float:
        """Return an earlier (estimated) drain to the bucket; returns the
        joules actually restored.  The level clips at capacity — a refund
        can never mint energy the battery cannot hold — and ``spent_j``
        is credited back so admission prepay + completion reconcile nets
        to the real metered spend."""
        if joules <= 0:
            return 0.0
        take = min(joules, self.capacity_j - self.level_j)
        self.level_j += take
        self.spent_j -= take
        return take

    def summary(self) -> dict:
        return {"capacity_j": round(self.capacity_j, 6),
                "level_j": round(self.level_j, 6),
                "frac": round(self.frac, 4),
                "harvested_j": round(self.harvested_j, 6),
                "wasted_j": round(self.wasted_j, 6),
                "spent_j": round(self.spent_j, 6),
                "shortfall_j": round(self.shortfall_j, 6)}


def budget_j(profile: PowerProfile, initial_level_j: float,
             t0: float, t1: float) -> float:
    """The orbit-average energy budget over [t0, t1]: what the battery
    held at t0 plus everything the profile harvests by t1.  A capped
    fleet's cumulative ``energy_j`` must stay within this (plus in-flight
    slack); an uncapped one is free to overshoot it."""
    return initial_level_j + profile.energy_between(t0, t1)
