"""Telemetry-driven autoscaler: grow/shrink the fleet from live signals
(the port's copy of ``repro.orbit.autoscale``).

The router dispatches over whatever pools exist; this module decides how
many should exist.  An :class:`Autoscaler` watches one *family* of pools
— a template :class:`~repro_torch.serving.spec.PoolSpec` plus the clones it
has spawned (named ``<template>/as<k>``) — and reacts to three
telemetry signals:

* **queue depth**: any family pool's live ``load`` at or above
  ``queue_high`` means the family is saturated — add a clone (or raise
  the template's ``capacity``, in ``grow="capacity"`` mode);
* **backpressure**: new engine ``OutOfBlocks`` deferrals since the last
  look mean the KV pool itself is the bottleneck — same response;
* **violations**: new fleet SLO violations mean provisioned capacity is
  already costing deadlines — same response.

Shrink is the mirror image: when the family's total load falls to
``queue_low`` the newest clone is retired *gracefully* — the pool stops
taking new dispatches, finishes everything queued and in flight (no
stream is ever dropped), and is removed once drained
(:meth:`~repro_torch.serving.client.ServingClient.retire_pool`).

Orbit awareness: scale-up is suppressed outside ``"nominal"`` energy
mode — spinning up capacity during an eclipse would spend the battery
faster exactly when the controller is trying to conserve it.  Scale-down
runs in any mode.

All decisions run on the fleet's virtual clock with a ``cooldown_s``
between actions, so scaling is deterministic for a given trace.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Optional


@dataclass
class ScalingPolicy:
    """Declarative scaling rules for one pool family (JSON-round-trips
    inside :class:`~repro_torch.orbit.spec.OrbitSpec`)."""
    template: str                    # PoolSpec name to clone / resize
    min_pools: int = 1
    max_pools: int = 3
    queue_high: int = 8              # per-pool load that triggers growth
    queue_low: int = 0               # family load at/below which we shrink
    cooldown_s: float = 0.25         # virtual seconds between actions
    grow: str = "pools"              # "pools" -> clone | "capacity" -> resize
    capacity_step: int = 1
    min_capacity: int = 1
    max_capacity: int = 8

    def __post_init__(self):
        if self.grow not in ("pools", "capacity"):
            raise ValueError(f"unknown grow mode {self.grow!r}")
        if self.min_pools < 1:
            raise ValueError("min_pools must keep at least one pool")
        if self.max_pools < self.min_pools:
            raise ValueError(f"max_pools {self.max_pools} < min_pools "
                             f"{self.min_pools}")
        if self.queue_low >= self.queue_high:
            # overlapping grow/shrink bands would oscillate add/retire
            # every cooldown at steady load
            raise ValueError(f"queue_low ({self.queue_low}) must be below "
                             f"queue_high ({self.queue_high})")
        if not 1 <= self.min_capacity <= self.max_capacity:
            raise ValueError(f"need 1 <= min_capacity <= max_capacity, "
                             f"got {self.min_capacity}/{self.max_capacity}")
        if self.capacity_step < 1:
            raise ValueError("capacity_step must be >= 1")

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ScalingPolicy":
        return cls(**d)


class Autoscaler:
    """Apply a :class:`ScalingPolicy` to a live fleet.

    ``template_spec`` is the :class:`~repro_torch.serving.spec.PoolSpec` clones
    are built from; clone names get a monotonically increasing suffix so
    a retired name is never reused (pool telemetry history stays
    unambiguous).
    """

    def __init__(self, policy: ScalingPolicy, template_spec):
        if template_spec.name != policy.template:
            raise ValueError(
                f"template spec {template_spec.name!r} does not match "
                f"policy template {policy.template!r}")
        self.policy = policy
        self.template_spec = template_spec
        self.actions: List[Dict] = []        # applied, for reports/tests
        self._seq = 0
        self._last_action_s = -math.inf
        self._deferrals_seen = 0
        self._violations_seen = 0
        self._pressure_latch = False         # edge signals held until usable

    # ------------------------------------------------------------------
    # signals
    # ------------------------------------------------------------------
    def family(self, client) -> List[str]:
        prefix = self.policy.template + "/as"
        return [n for n in client.router.pools
                if n == self.policy.template or n.startswith(prefix)]

    def _pressure(self, client, pools) -> bool:
        """Saturation from queue depth, backpressure, or violations.
        The deferral/violation deltas are edge-triggered, so they latch:
        a burst recorded while growth is suppressed (eclipse mode) still
        counts once growth is allowed again.  The latch clears when the
        family's backlog falls to ``queue_low`` — a violation recorded as
        the last late batch *completes* must not grow a fleet that is
        already idle."""
        tel = client.router.telemetry
        deferrals = sum(tel.pools[p.name].deferrals for p in pools)
        if (deferrals > self._deferrals_seen
                or tel.violations > self._violations_seen):
            self._pressure_latch = True
        self._deferrals_seen = deferrals
        self._violations_seen = tel.violations
        if sum(p.load for p in pools) <= self.policy.queue_low:
            self._pressure_latch = False     # pressure resolved itself
        return (max(p.load for p in pools) >= self.policy.queue_high
                or self._pressure_latch)

    # ------------------------------------------------------------------
    # control step
    # ------------------------------------------------------------------
    def step(self, client, now: float, mode: str = "nominal",
             hold_scale_down: bool = False) -> Optional[Dict]:
        """Evaluate the policy once; apply and return at most one action
        (None when nothing fires).  Called by the FleetController on the
        fleet clock.  ``hold_scale_down`` suppresses the shrink branches
        (the controller sets it while any SLO alert fires — retiring
        capacity mid-burn would feed the regression it alerts on)."""
        p = self.policy
        if now - self._last_action_s < p.cooldown_s:
            return None
        live = client.router.pools
        pools = [live[n] for n in self.family(client) if not live[n].draining]
        if not pools:
            return None
        hot = self._pressure(client, pools)
        idle = sum(f.load for f in pools) <= p.queue_low
        act = None
        if p.grow == "capacity":
            base = live.get(p.template)
            if base is None:
                return None
            if hot and mode == "nominal" and base.capacity < p.max_capacity:
                cap = min(p.max_capacity, base.capacity + p.capacity_step)
                client.set_capacity(p.template, cap)
                act = {"op": "set_capacity", "pool": p.template,
                       "capacity": cap, "t": round(now, 4)}
            elif idle and not hold_scale_down \
                    and base.capacity > p.min_capacity:
                cap = max(p.min_capacity, base.capacity - p.capacity_step)
                client.set_capacity(p.template, cap)
                act = {"op": "set_capacity", "pool": p.template,
                       "capacity": cap, "t": round(now, 4)}
        else:
            if hot and mode == "nominal" and len(pools) < p.max_pools:
                name = f"{p.template}/as{self._seq}"
                self._seq += 1
                client.add_pool(replace(self.template_spec, name=name))
                act = {"op": "add", "pool": name, "t": round(now, 4)}
            elif idle and not hold_scale_down and len(pools) > p.min_pools:
                clones = [f.name for f in pools
                          if f.name != p.template]
                if clones:
                    victim = clones[-1]          # newest clone drains first
                    client.retire_pool(victim)
                    act = {"op": "retire", "pool": victim,
                           "t": round(now, 4)}
        if act is not None:
            self._last_action_s = now
            self.actions.append(act)
        return act
