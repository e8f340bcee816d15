"""Orbit-aware serving on the PyTorch port: an energy-capped, self-scaling
fleet, end to end (the twin of ``examples/orbit_eclipse.py``).

The data plane is the port's ``repro_torch.serving`` facade; this example
attaches the ``repro_torch.orbit`` control plane on top and walks one
day-in-the-life:

  1. declare the fleet (FleetSpec) and the orbit (OrbitSpec): a
     sunlit/eclipse power cycle, a battery-sized energy bucket, and a
     pool-cloning scaling policy;
  2. submit mixed traffic across an eclipse — watch offline work defer
     while downlink-critical work keeps flowing;
  3. sunlight returns: the backlog releases at the rate the solar array
     funds, the autoscaler grows the board family against the queue and
     retires the clones when it drains;
  4. read one telemetry schema for all of it: budget ratio, mode
     transitions, scale actions, per-pool energy.

    PYTHONPATH=src python examples_torch/orbit_eclipse.py [--requests 200] \\
        [--device cpu]

The pools are cost-model pools; ``--device`` (default ``cuda``) is where
the fleet is built, and without a card the example stops rather than
fall back.
"""
import argparse
import json

from repro_torch.launch import require_device
from repro_torch.launch.orbit import MIX, eclipse_orbit_spec, mix_demand_w
from repro_torch.launch.route import vision_fleet_spec
from repro_torch.orbit import ScalingPolicy, budget_j
from repro_torch.router import SLO_CLASSES
from repro_torch.serving.traffic import open_loop


def attach_orbit(rate_hz: float, device="cuda"):
    """1. fleet + orbit as data (both JSON-round-trippable specs); the
    traffic mix is the launcher/bench scenario's canonical one."""
    client = vision_fleet_spec().build(device=device)
    demand_w = mix_demand_w(client, rate_hz, mix=MIX)
    ospec = eclipse_orbit_spec(
        demand_w,
        scaling=ScalingPolicy(template="board-a", max_pools=3,
                              queue_high=6, cooldown_s=0.1))
    print("orbit:", json.dumps(ospec.to_dict(), indent=2))
    return client, ospec, ospec.attach(client)


def drive(client, rate_hz: float, n_requests: int, seed: int):
    """2-3. mixed open-loop traffic across the eclipse; the client's own
    clock drives the controller (bucket, modes, release, autoscaler)."""
    classes = [SLO_CLASSES[n] for n, _ in MIX]
    handles = open_loop(client, classes, [w for _, w in MIX],
                        rate_hz=rate_hz, n_requests=n_requests, seed=seed)
    for _ in range(300):
        client.step()                     # idle tail: clones retire
    return handles


def report(client, ospec, ctrl, handles) -> dict:
    """4. one schema for the whole story."""
    snap = client.telemetry
    budget = budget_j(ospec.profile(), ospec.initial_frac * ospec.bucket_j,
                      0.0, client.now)
    print(f"\n{snap['completed']} completed / {snap['dropped']} dropped; "
          f"{snap['energy_deferred']} deferred through the eclipse, "
          f"{snap['violations']} SLO violations (latency traded for "
          f"energy)")
    print(f"energy: {snap['energy_j']:.3f} J of a {budget:.3f} J "
          f"orbit-average budget "
          f"({snap['energy_j'] / budget:.2f}x)")
    print("mode transitions:", ctrl.report()["transitions"])
    print("scale actions:", ctrl.report()["scale_actions"])
    print("per-pool energy:",
          {k: v["energy_j"] for k, v in snap["pools"].items()})
    assert all(h.done for h in handles), "stranded requests"
    return {"telemetry": snap, "report": ctrl.report(), "budget_j": budget}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(ap, args.device)
    client, ospec, ctrl = attach_orbit(args.rate, args.device)
    handles = drive(client, args.rate, args.requests, args.seed)
    return report(client, ospec, ctrl, handles)


if __name__ == "__main__":
    main()
