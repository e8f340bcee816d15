"""Orbit-controller demo: ride a sunlit/eclipse power cycle live (the port
of ``repro.launch.orbit``).

    PYTHONPATH=src python -m repro_torch.launch.orbit            # capped
    PYTHONPATH=src python -m repro_torch.launch.orbit --uncontrolled  # baseline
    PYTHONPATH=src python -m repro_torch.launch.orbit --json

The canonical vision fleet (``launch/route.py``) serves a mixed-SLO
open-loop trace whose arrivals straddle an eclipse.  With the
controller attached (:class:`~repro_torch.orbit.OrbitSpec`), the energy
bucket drains through the eclipse, the fleet flips to energy-first plan
selection, offline-class work parks until sunlight returns, and the
autoscaler grows/shrinks the DPU+VPU board family against queue depth —
cumulative fleet ``energy_j`` stays inside the orbit-average budget.
Uncontrolled, the same trace burns through the budget mid-eclipse.

Everything runs on the fleet's virtual clock (cost-model pools), so a
given seed reproduces the identical trace, budget, and scale events on
any machine.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.route import vision_fleet_spec
from repro_torch.orbit import OrbitSpec, PhaseSpec, ScalingPolicy, budget_j
from repro_torch.router import SLO_CLASSES, select_plan
from repro_torch.serving.traffic import open_loop

# offline-heavy mix with a critical floor: the deferrable classes ride
# the bucket, downlink-critical keeps dispatching through the eclipse
MIX = [("downlink-critical", 0.2), ("background-science", 0.5),
       ("bulk-reprocess", 0.3)]


def eclipse_orbit_spec(demand_w: float, *, sunlit_s: float = 1.0,
                       eclipse_s: float = 4.0, sunlit_margin: float = 1.3,
                       eclipse_frac: float = 0.1, bucket_s: float = 1.0,
                       scaling: ScalingPolicy = None) -> OrbitSpec:
    """Size an orbit around the fleet's nominal demand (watts): harvest
    ``sunlit_margin`` x demand in sunlight, ``eclipse_frac`` x demand in
    shadow, with a battery holding ``bucket_s`` seconds of demand."""
    return OrbitSpec(
        phases=[PhaseSpec("sunlit", sunlit_s, sunlit_margin * demand_w),
                PhaseSpec("eclipse", eclipse_s, eclipse_frac * demand_w)],
        bucket_j=bucket_s * demand_w,
        scaling=scaling)


def mix_demand_w(client, rate_hz: float, mix=MIX) -> float:
    """The fleet's nominal electrical demand for an arrival mix: each
    class priced at the plan nominal dispatch would pick for it (not the
    frontier's global minimum — critical classes buy fast, dear plans,
    and sizing the orbit below their real draw would put the controller
    in eclipse posture even in full sunlight)."""
    per_req = 0.0
    for name, w in mix:
        plan = select_plan(client.router.frontier, SLO_CLASSES[name],
                           latency_headroom=client.router.latency_headroom)
        if plan is not None:
            per_req += w * plan.energy_j
    return rate_hz * per_req


def run_eclipse_scenario(n_requests: int = 300, rate_hz: float = 60.0,
                         seed: int = 0, controlled: bool = True,
                         scale: bool = True,
                         trace_path: str = None) -> dict:
    """One eclipse transition, controller on or off; returns the report.

    Both variants are scored against the *same* orbit-average budget
    (battery at t=0 plus harvest up to each run's own end time), so
    ``energy_ratio <= 1`` means the fleet lived within the orbit.
    """
    client = vision_fleet_spec().build()
    demand_w = mix_demand_w(client, rate_hz)
    scaling = (ScalingPolicy(template="board-a", min_pools=1, max_pools=3,
                             queue_high=6, queue_low=0, cooldown_s=0.1)
               if scale else None)
    ospec = eclipse_orbit_spec(demand_w, scaling=scaling)
    ctrl = ospec.attach(client) if controlled else None
    if trace_path:
        client.enable_tracing()

    classes = [SLO_CLASSES[n] for n, _ in MIX]
    weights = [w for _, w in MIX]
    handles = open_loop(client, classes, weights, rate_hz=rate_hz,
                        n_requests=n_requests, seed=seed)
    for _ in range(300):                 # idle tail: let clones retire
        client.step()
    t_end = client.now

    snap = client.telemetry
    spent = snap["energy_j"]
    budget = budget_j(ospec.profile(), ospec.initial_frac * ospec.bucket_j,
                      0.0, t_end)
    admitted = max(snap["admitted"], 1)
    report = {
        "scenario": ("orbit_eclipse_on" if controlled
                     else "orbit_eclipse_off"),
        "controlled": controlled,
        "requests": n_requests,
        "rate_hz": rate_hz,
        "t_end_s": round(t_end, 3),
        "energy_j": spent,
        "budget_j": round(budget, 4),
        "energy_ratio": round(spent / budget, 4),
        "orbit_average_w": round(ospec.profile().orbit_average_w, 6),
        "admitted": snap["admitted"],
        "completed": snap["completed"],
        "rejected": snap["rejected"],
        "dropped": snap["dropped"],
        "violations": snap["violations"],
        "violation_rate": round(snap["violations"] / admitted, 4),
        "deferred": snap["energy_deferred"],
        "energy_rejected": snap["energy_rejected"],
        "pools_added": snap["pools_added"],
        "pools_retired": snap["pools_retired"],
        "unresolved_handles": sum(not h.done for h in handles),
    }
    if ctrl is not None:
        report["controller"] = ctrl.report()
    if trace_path:
        from repro_torch.obs import export_chrome_trace
        trace = export_chrome_trace(client, trace_path)
        report["trace_events"] = len(trace["traceEvents"])
        report["trace_path"] = str(trace_path)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--uncontrolled", action="store_true",
                    help="baseline: same trace without the controller")
    ap.add_argument("--no-scale", action="store_true",
                    help="energy cap only, no autoscaler")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace_event JSON of the run — "
                         "pool lanes, orbit phases, counter tracks "
                         "(open in Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)

    report = run_eclipse_scenario(n_requests=args.requests,
                                  rate_hz=args.rate, seed=args.seed,
                                  controlled=not args.uncontrolled,
                                  scale=not args.no_scale,
                                  trace_path=args.trace)
    print(json.dumps(report, indent=2))
    if not args.json:
        word = "inside" if report["energy_ratio"] <= 1.0 else "OVER"
        print(f"\n{report['scenario']}: spent {report['energy_j']:.3f} J "
              f"of a {report['budget_j']:.3f} J orbit budget "
              f"({report['energy_ratio']:.2f}x — {word}); "
              f"{report['deferred']} deferred, "
              f"{report['violations']} violations, "
              f"{report['pools_added']} pools added / "
              f"{report['pools_retired']} retired")


if __name__ == "__main__":
    main()
