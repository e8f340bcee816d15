"""The closed control loop over the serving fleet: energy cap + scaling
(the port's copy of ``repro.orbit.controller``).

:class:`FleetController` runs beside the router on the fleet's virtual
clock (the :class:`~repro_torch.serving.client.ServingClient` steps it from
``advance()``, so ``result()``/``stream()``/``drain()``/``open_loop``
all drive it for free).  Each tick it:

1. **banks and drains the energy bucket** — harvest from the orbit
   power profile since the last tick in, the fleet's telemetry
   ``energy_j`` delta out;
2. **derives the dispatch mode** from the bucket level::

       frac > conserve_frac                ->  "nominal"
       critical_frac < frac <= conserve    ->  "conserve"
       frac <= critical_frac               ->  "critical"

   and mirrors it onto ``Router.energy_mode`` so plan selection flips
   from latency-slack-first to energy-first;
3. **applies the admission policy** (consulted by ``ServingClient.submit``
   *before* the router sees a request): in nominal mode everything
   dispatches; below it, deferrable work (SLO priority at or below
   ``defer_max_priority`` — the offline/background classes) parks in the
   deferral queue instead of draining the battery; non-deferrable work
   still dispatches on the energy-first frontier, and is rejected only
   as a last resort — critical mode with a bone-dry bucket;
4. **releases the deferral queue** when the mode recovers to nominal
   (requests keep their original arrival time, so the latency-for-energy
   trade is recorded honestly as end-to-end latency / violations);
5. **steps the autoscaler**, if the spec declared one.

Degradation order under a shrinking bucket is therefore: cheaper plans
-> deferred offline work -> rejection, matching MPAI's premise that an
onboard fleet rides the speed-accuracy-energy frontier under a hard
power envelope rather than dropping work at the first brown-out.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.orbit.autoscale import Autoscaler
from repro_torch.orbit.power import EnergyBucket

MODES = ("nominal", "conserve", "critical")


class FleetController:
    """One instance per ServingClient; built by ``OrbitSpec.attach``."""

    def __init__(self, client, bucket: EnergyBucket, spec,
                 autoscaler: Optional[Autoscaler] = None):
        self.client = client
        self.bucket = bucket
        self.spec = spec                       # OrbitSpec (thresholds)
        self.autoscaler = autoscaler
        self.mode = "nominal"
        self.deferred: List = []               # parked RouterRequests
        self.transitions: List[Tuple[float, str]] = []
        # radiation-storm pressure: leaky integrator of hardening-event
        # deltas (retries + watchdog trips + bitflips + quarantines +
        # handoff replays); at/above spec.storm_events the mode floors
        # at "conserve"
        self.storm_pressure = 0.0
        self._seen_events = self._hardening_events()
        self._seen_j = self._fleet_energy_j()
        # admission-time energy prepay: rid -> estimated joules drained
        # at submit, refunded when the request settles (the real metered
        # spend drains through the telemetry delta path as usual, so
        # prepay + reconcile nets to the actual draw)
        self._prepaid: Dict[int, float] = {}
        self.initial_level_j = bucket.level_j
        bucket.rebase(client.now)              # no phantom pre-attach harvest
        client.attach_controller(self)
        self._set_mode(client.now)             # honor the initial level

    # ------------------------------------------------------------------
    # signals
    # ------------------------------------------------------------------
    def _fleet_energy_j(self) -> float:
        """Cumulative fleet spend: retired pools keep their counters in
        telemetry, so this is monotone across scale-downs."""
        return sum(c.energy_j
                   for c in self.client.router.telemetry.pools.values())

    def _hardening_events(self) -> int:
        """Cumulative count of every hardening event the fleet has
        recorded — the storm ladder's raw signal.  Fired SLO pages join
        it: a burning error budget is evidence of environmental stress
        exactly like retries and bitflips are."""
        t = self.client.router.telemetry
        return (t.retries + t.watchdog_trips + t.alerts.pages_fired
                + sum(c.bitflips_detected + c.blocks_quarantined
                      + c.watchdog_trips + c.handoffs_replayed
                      for c in t.pools.values()))

    @property
    def storm(self) -> bool:
        return (self.spec.storm_events > 0
                and self.storm_pressure >= self.spec.storm_events)

    @property
    def deferred_count(self) -> int:
        return len(self.deferred)

    # ------------------------------------------------------------------
    # admission policy (consulted by ServingClient.submit)
    # ------------------------------------------------------------------
    def deferrable(self, slo) -> bool:
        return slo.priority <= self.spec.defer_max_priority

    def admission(self, req) -> str:
        """One of "dispatch" | "defer" | "reject" for a fresh request."""
        if self.mode == "nominal":
            return "dispatch"
        if self.deferrable(req.slo):
            return "defer"
        if self.mode == "critical" and self.bucket.level_j <= 0.0:
            return "reject"                    # last resort: battery dry
        return "dispatch"

    def prepay(self, req, tokens: Optional[int]) -> None:
        """Charge a freshly dispatched request's *expected* plan energy
        against the bucket so the controller sees load the moment it is
        admitted, not ``pool_latency_s`` later when its tokens decode.
        The estimate is the optimistic energy floor (the frontier's
        cheapest plan per token — the same floor ``_release`` meters
        against) times the declared token budget, capped at the current
        level so an estimate never manufactures shortfall the fleet
        would not really incur.  ``step()`` refunds the full prepay when
        the request settles; the real spend drains via the telemetry
        ``energy_j`` delta, so the bucket nets to the metered draw."""
        if not tokens or tokens <= 0:
            return
        floor = min((p.energy_j for p in self.client.router.frontier),
                    default=0.0)
        est = min(floor * tokens, self.bucket.level_j)
        if est <= 0.0:
            return
        self.bucket.drain(est)
        self._prepaid[req.rid] = est
        self._set_mode(self.client.now)

    def defer(self, req, now: Optional[float] = None) -> None:
        req.deferred = True
        self.deferred.append(req)
        self.client.router.telemetry.energy_deferred += 1
        self.client.router.telemetry.tracer.begin(
            req.rid, "defer", self.client.now if now is None else now,
            mode=self.mode)

    # ------------------------------------------------------------------
    # control step (called from ServingClient.advance every tick)
    # ------------------------------------------------------------------
    def step(self, now: float) -> None:
        self.bucket.advance(now)
        if self._prepaid:
            # reconcile settled requests: hand the admission-time
            # estimate back (the real spend has drained — or is about
            # to — through the telemetry delta below)
            handles = self.client._handles
            for rid in [r for r in self._prepaid
                        if (h := handles.get(r)) is None or h.done]:
                self.bucket.refund(self._prepaid.pop(rid))
        spent = self._fleet_energy_j()
        if spent > self._seen_j:               # drain against real work
            self.bucket.drain(spent - self._seen_j)
            self._seen_j = spent
        if self.spec.storm_events > 0:
            ev = self._hardening_events()
            self.storm_pressure = (self.storm_pressure
                                   * self.spec.storm_decay
                                   + (ev - self._seen_events))
            self._seen_events = ev
        self._set_mode(now)
        if self.mode == "nominal" and self.deferred:
            self._release(now)
        if self.autoscaler is not None:
            # never retire capacity while any SLO alert fires: scale-down
            # during a burn converts a latency regression into a spiral
            hold = self.client.router.telemetry.alerts.firing_count > 0
            self.autoscaler.step(self.client, now, mode=self.mode,
                                 hold_scale_down=hold)

    def _set_mode(self, now: float) -> None:
        """Threshold the bucket level with hysteresis: dropping a mode
        happens at the threshold, climbing back requires an extra
        ``hysteresis_frac`` of charge — so the mode doesn't chatter while
        the level rides a boundary."""
        f = self.bucket.frac
        crit, cons = self.spec.critical_frac, self.spec.conserve_frac
        h = self.spec.hysteresis_frac
        if f <= crit or (self.mode == "critical" and f <= crit + h):
            mode = "critical"
        elif f <= cons or (self.mode != "nominal" and f <= cons + h):
            mode = "conserve"
        else:
            mode = "nominal"
        paging = self.client.router.telemetry.alerts.paging
        if mode == "nominal" and (self.storm or paging):
            # storm ladder / SLO burn: retry pressure or a firing page
            # alert floors the mode at conserve even on a healthy
            # battery (scale-ups are suppressed for free — the
            # autoscaler already gates on mode)
            mode = "conserve"
        if mode != self.mode or not self.transitions:
            self.mode = mode
            self.transitions.append((round(now, 4), mode))
            self.client.router.telemetry.tracer.event(
                "mode", now, mode=mode, bucket_frac=round(f, 4),
                storm=self.storm, paging=paging)
        self.client.router.energy_mode = ("nominal" if mode == "nominal"
                                          else "conserve")

    def _release(self, now: float) -> None:
        """Sunlight is back: dispatch parked work, oldest first — but
        *metered* against the bucket's headroom above the conserve
        threshold.  Releasing the whole eclipse backlog in one burst
        would drain the battery straight back below the threshold and
        overshoot the orbit budget; instead each released request is
        charged its optimistic energy floor (the frontier's cheapest
        plan) against the headroom, so the backlog drains at the rate
        sunlight actually funds.  A release the router now rejects (load
        estimate) is surfaced on the handle like any admission-time
        rejection."""
        router = self.client.router
        floor = min((p.energy_j for p in router.frontier), default=0.0)
        headroom = (self.bucket.level_j
                    - self.spec.conserve_frac * self.bucket.capacity_j)
        while self.deferred and headroom > 0.0:
            req = self.deferred.pop(0)
            req.deferred = False
            # a failed release ends the chain via the router's rejection
            # path, which also sweeps up a still-open defer span
            router.telemetry.tracer.finish(req.rid, "defer", now)
            ok = router.submit(req, now)
            handle = self.client._handles.get(req.rid)
            if handle is not None:
                handle.admitted = ok
            headroom -= max(floor, 1e-12)  # floor=0 still makes progress

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def report(self) -> Dict:
        return {
            "mode": self.mode,
            "deferred_waiting": self.deferred_count,
            "storm_pressure": round(self.storm_pressure, 4),
            # expected-energy prepays still outstanding (admitted work
            # whose tokens have not finished decoding)
            "prepaid_j": round(sum(self._prepaid.values()), 6),
            "alerts": self.client.router.telemetry.alerts.snapshot(),
            "bucket": self.bucket.summary(),
            # per-pool spend the bucket drained against — disaggregated
            # pools show their co-processing split here (the `.prefill`
            # stage pool is charged separately from its decode pool)
            "energy_by_pool": {
                name: round(c.energy_j, 4) for name, c in
                sorted(self.client.router.telemetry.pools.items())},
            "transitions": [{"t": t, "mode": m}
                            for t, m in self.transitions],
            "scale_actions": ([] if self.autoscaler is None
                              else list(self.autoscaler.actions)),
            # what the fleet looked like DURING the orbit, not just at
            # its end: the ring-buffered per-tick samples' roll-up
            "timeseries": self.client.timeseries.summary(),
        }
