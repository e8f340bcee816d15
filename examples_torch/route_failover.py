"""Minimal fleet-router example on the PyTorch port: three pools, one SEU,
zero lost requests (the twin of ``examples/route_failover.py``).

    PYTHONPATH=src python examples_torch/route_failover.py [--device cpu]

Routes 60 mixed-SLO UrsoNet inferences across two DPU+VPU boards and an
EdgeTPU sidecar — five lines of fleet spec, one submission interface.
The sidecar is the energy-optimal operating point, so the router loads
it up; at t=0.5s it takes a transient SEU and its queued and in-flight
requests are rescheduled onto the (dearer) boards.  Every admitted
request completes — deadline misses are *reported*, not dropped.  The
pools are cost-model pools: ``--device`` (default ``cuda``) is where the
fleet is built, and without a card the example stops rather than fall
back.
"""
import argparse

from repro_torch.launch import require_device
from repro_torch.router import SLO_CLASSES
from repro_torch.serving import FaultSpec, FleetSpec, PoolSpec, open_loop


def build_fleet(device="cuda"):
    spec = FleetSpec(
        pools=[PoolSpec("board-a", ("mpsoc_dpu", "myriadx_vpu"), capacity=2),
               PoolSpec("board-b", ("mpsoc_dpu", "myriadx_vpu"), capacity=2),
               PoolSpec("sidecar", ("edge_tpu", "cortex_a53"), capacity=1)],
        workload="ursonet",
        accuracy_penalty={"mpsoc_dpu": 0.05},
        faults=[FaultSpec("sidecar", at_s=0.5, duration_s=1.0)])
    return spec.build(device=device)


def route(client):
    classes = list(SLO_CLASSES.values())
    weights = [1.0 / len(classes)] * len(classes)
    return open_loop(client, classes, weights, rate_hz=30.0, n_requests=60)


def report(client, handles) -> dict:
    snap = client.telemetry
    print(f"admitted={snap['admitted']} completed={snap['completed']} "
          f"violations={snap['violations']} dropped={snap['dropped']} "
          f"failovers={snap['failovers']}")
    rerouted = sum(h.telemetry["rerouted"] > 0 for h in handles)
    print(f"{rerouted} requests were displaced by the SEU and re-served "
          f"by the surviving boards")
    assert snap["completed"] + snap["dropped"] == snap["admitted"]
    assert rerouted > 0, "the fault should displace in-flight work"
    return {**snap, "rerouted": rerouted}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(ap, args.device)
    client = build_fleet(args.device)
    return report(client, route(client))


if __name__ == "__main__":
    main()
