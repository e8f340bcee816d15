"""OrbitSpec — the orbit control plane as data, like FleetSpec
(the port's copy of ``repro.orbit.spec``).

An :class:`OrbitSpec` declares everything the fleet controller needs —
the cyclic power profile (:class:`PhaseSpec` per sunlit/eclipse leg),
the battery/bucket size and initial charge, the mode thresholds, which
SLO priorities may be deferred, and (optionally) a
:class:`~repro_torch.orbit.autoscale.ScalingPolicy`.  ``to_dict`` /
``from_dict`` round-trip losslessly through JSON, mirroring
``FleetSpec``, so a launcher flag set, a benchmark scenario, and a test
fixture share one config path for the control plane too.

``attach(client)`` builds the live controller onto an existing
:class:`~repro_torch.serving.client.ServingClient`::

    client = fleet_spec.build()
    ctrl = OrbitSpec(phases=[PhaseSpec("sunlit", 60.0, 8.0),
                             PhaseSpec("eclipse", 35.0, 1.0)],
                     bucket_j=120.0).attach(client)
    ...                                  # submit / open_loop as usual
    print(ctrl.report())
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from repro_torch.orbit.autoscale import Autoscaler, ScalingPolicy
from repro_torch.orbit.controller import FleetController
from repro_torch.orbit.power import EnergyBucket, OrbitPhase, PowerProfile


@dataclass
class PhaseSpec:
    """One orbit phase as data (sunlit/eclipse leg of the power cycle)."""
    name: str
    duration_s: float
    power_w: float

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "PhaseSpec":
        unknown = sorted(set(d) - {"name", "duration_s", "power_w"})
        if unknown:
            raise ValueError(
                f"PhaseSpec.from_dict: unknown key(s) {unknown}; valid "
                f"keys are ['duration_s', 'name', 'power_w']")
        return cls(**d)


@dataclass
class OrbitSpec:
    """The orbit control plane as data; ``attach()`` makes it live."""
    phases: List[PhaseSpec]
    bucket_j: float                       # battery capacity
    initial_frac: float = 1.0             # charge at t=0
    conserve_frac: float = 0.5            # below -> prefer cheap plans, defer
    critical_frac: float = 0.15           # below -> reject as a last resort
    hysteresis_frac: float = 0.05         # extra charge needed to mode-up
    defer_max_priority: int = 0           # SLO priority <= this is deferrable
    scaling: Optional[ScalingPolicy] = None
    # radiation-storm response: the controller keeps a leaky integrator
    # of hardening events (retries, watchdog trips, detected bitflips,
    # quarantined blocks, replayed handoffs).  While the pressure is at
    # or above ``storm_events`` the dispatch mode floors at "conserve" —
    # cheap plans, deferred background work, no scale-ups — even on a
    # full battery: a storm spikes the retry bill, so spending the
    # margin on throughput invites the next upset to waste it.  0
    # disables the ladder.
    storm_events: int = 0                 # pressure threshold; 0 -> off
    storm_decay: float = 0.9              # per-tick integrator decay

    def __post_init__(self):
        if not 0.0 <= self.critical_frac <= self.conserve_frac <= 1.0:
            raise ValueError(
                "need 0 <= critical_frac <= conserve_frac <= 1, got "
                f"{self.critical_frac} / {self.conserve_frac}")
        if self.hysteresis_frac < 0.0:
            raise ValueError("hysteresis_frac must be >= 0")
        if not 0.0 <= self.storm_decay < 1.0:
            raise ValueError("storm_decay must be in [0, 1)")

    # ------------------------------------------------------------------
    # serialization (JSON round-trip, like FleetSpec)
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "phases": [p.to_dict() for p in self.phases],
            "bucket_j": self.bucket_j,
            "initial_frac": self.initial_frac,
            "conserve_frac": self.conserve_frac,
            "critical_frac": self.critical_frac,
            "hysteresis_frac": self.hysteresis_frac,
            "defer_max_priority": self.defer_max_priority,
            "scaling": (None if self.scaling is None
                        else self.scaling.to_dict()),
            "storm_events": self.storm_events,
            "storm_decay": self.storm_decay,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "OrbitSpec":
        d = dict(d)
        valid = {f for f in cls.__dataclass_fields__}
        unknown = sorted(set(d) - valid)
        if unknown:
            raise ValueError(
                f"OrbitSpec.from_dict: unknown key(s) {unknown}; valid "
                f"keys are {sorted(valid)}")
        d["phases"] = [PhaseSpec.from_dict(p) for p in d["phases"]]
        sc = d.get("scaling")
        d["scaling"] = None if sc is None else ScalingPolicy.from_dict(sc)
        return cls(**d)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self) -> "OrbitSpec":
        """Fail fast before the controller goes live.  ``__post_init__``
        already pins the mode-threshold ordering; this checks the parts
        a JSON round-trip can still get wrong — the power profile and
        battery sizing.  Called by ``attach()``."""
        if not self.phases:
            raise ValueError("OrbitSpec needs at least one PhaseSpec — "
                             "the power profile cannot be empty")
        for p in self.phases:
            if p.duration_s <= 0:
                raise ValueError(f"phase {p.name!r}: duration_s must be "
                                 f"> 0 (got {p.duration_s})")
            if p.power_w < 0:
                raise ValueError(f"phase {p.name!r}: power_w must be "
                                 f">= 0 (got {p.power_w})")
        if self.bucket_j <= 0:
            raise ValueError(f"bucket_j must be > 0 (got {self.bucket_j})")
        if not 0.0 <= self.initial_frac <= 1.0:
            raise ValueError(f"initial_frac must be in [0, 1] "
                             f"(got {self.initial_frac})")
        if self.storm_events < 0:
            raise ValueError(f"storm_events must be >= 0 "
                             f"(got {self.storm_events})")
        return self

    # ------------------------------------------------------------------
    # assembly
    # ------------------------------------------------------------------
    def profile(self) -> PowerProfile:
        return PowerProfile([OrbitPhase(p.name, p.duration_s, p.power_w)
                             for p in self.phases])

    def bucket(self) -> EnergyBucket:
        return EnergyBucket(self.bucket_j, self.profile(),
                            level_j=self.initial_frac * self.bucket_j)

    def attach(self, client, template=None) -> FleetController:
        """Build the live controller onto a ServingClient.

        ``template`` — the :class:`~repro_torch.serving.spec.PoolSpec` the
        autoscaler clones; defaults to the entry in the client's
        ``FleetSpec`` whose name matches ``scaling.template``.
        """
        self.validate()
        scaler = None
        if self.scaling is not None:
            if template is None:
                pools = [] if client.spec is None else client.spec.pools
                match = [p for p in pools if p.name == self.scaling.template]
                if not match:
                    raise ValueError(
                        f"scaling template {self.scaling.template!r} not "
                        f"found in the client's FleetSpec; pass template=")
                template = match[0]
            scaler = Autoscaler(self.scaling, template)
        return FleetController(client, self.bucket(), self,
                               autoscaler=scaler)
