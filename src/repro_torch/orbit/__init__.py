"""repro_torch.orbit — orbit-aware fleet control over the serving data plane
(the port of ``repro.orbit``; plain Python on the fleet's virtual clock).

MPAI's premise is power-efficient *on-board* inference: the fleet rides
speed-accuracy-energy trade-offs under a hard spacecraft power envelope,
not just per-request SLOs.  ``repro_torch.serving`` is the data plane (specs,
router, engines, streams); this package is the control plane that makes
the fleet track the orbit instead of being provisioned for peak:

* a **global energy token bucket** (``power.py``) refilled by a cyclic
  sunlit/eclipse :class:`PowerProfile` on the fleet's deterministic
  virtual clock and drained by the pools' telemetry ``energy_j``;
* an **energy-aware dispatch mode**: as the bucket empties the router
  flips to energy-first plan selection, offline-class work is deferred
  until sunlight returns, and only a critical-mode dry bucket rejects;
* a **telemetry-driven autoscaler** (``autoscale.py``) that grows and
  shrinks the fleet live — queue depth, OutOfBlocks backpressure, and
  SLO violations trigger ``ServingClient.add_pool`` /
  ``retire_pool`` / ``set_capacity``; retirements drain gracefully and
  never drop an in-flight stream;
* an :class:`OrbitSpec` (``spec.py``) declaring all of it as
  JSON-round-trippable data, and a :class:`FleetController`
  (``controller.py``) ``step()`` loop the ServingClient clock drives
  automatically.

Quickstart::

    from repro_torch.orbit import OrbitSpec, PhaseSpec, ScalingPolicy

    client = fleet_spec.build()                  # the data plane
    ctrl = OrbitSpec(
        phases=[PhaseSpec("sunlit", 60.0, 8.0),  # harvest 8 W for 60 s
                PhaseSpec("eclipse", 35.0, 1.0)],
        bucket_j=120.0,
        scaling=ScalingPolicy(template="lm", max_pools=3),
    ).attach(client)
    ...                                          # submit / open_loop as usual
    print(ctrl.report())                         # mode, bucket, scale actions

Demo: ``PYTHONPATH=src python -m repro_torch.launch.orbit``.
"""
from repro_torch.orbit.autoscale import Autoscaler, ScalingPolicy
from repro_torch.orbit.controller import MODES, FleetController
from repro_torch.orbit.power import (EnergyBucket, OrbitPhase, PowerProfile,
                               budget_j)
from repro_torch.orbit.spec import OrbitSpec, PhaseSpec

__all__ = [
    "Autoscaler", "EnergyBucket", "FleetController", "MODES", "OrbitPhase",
    "OrbitSpec", "PhaseSpec", "PowerProfile", "ScalingPolicy", "budget_j",
]
