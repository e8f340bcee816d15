"""Fleet-router demo: SLO-aware dispatch across accelerator pools with a
mid-run fault and online failover — all through the ``repro_torch.serving``
facade (declarative :class:`FleetSpec` + :class:`ServingClient`); the port
of ``repro.launch.route``.

    PYTHONPATH=src python -m repro_torch.launch.route           # vision fleet
    PYTHONPATH=src python -m repro_torch.launch.route --lm      # + TPU pod LM
    PYTHONPATH=src python -m repro_torch.launch.route --execute-lm --smoke \
        --arch qwen3-14b                             # real decode, on the card

The vision section routes a mixed-SLO UrsoNet workload across three
pools (two DPU+VPU boards, one EdgeTPU+CPU sidecar); at ``--fault-at``
board-b takes an SEU and drops out for ``--fault-duration`` seconds —
its queued and in-flight requests are rescheduled over the survivors.
The LM sections route the same SLO machinery over TPU v5e operating
points (cost-model pools, or the continuous-batching engine behind an
engine-backed pool with ``--execute-lm``, which decodes on ``--device``:
the card unless ``--device cpu`` is given).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.launch import require_device
from repro_torch.router import SLO_CLASSES
from repro_torch.serving import FaultSpec, FleetSpec, PoolSpec
from repro_torch.serving.traffic import open_loop


def vision_fleet_spec(faults=()) -> FleetSpec:
    """The canonical three-pool MPAI vision fleet — two DPU+VPU boards
    and an EdgeTPU+CPU sidecar with a QAT'd-backbone accuracy prior.
    The orbit and dashboard launchers reuse this spec, so every demo
    measures one fleet."""
    return FleetSpec(
        pools=[
            PoolSpec("board-a", ("mpsoc_dpu", "myriadx_vpu"),
                     capacity=2, max_window=4),
            PoolSpec("board-b", ("mpsoc_dpu", "myriadx_vpu"),
                     capacity=2, max_window=4),
            PoolSpec("sidecar", ("edge_tpu", "cortex_a53"),
                     capacity=1, max_window=2),
        ],
        workload="ursonet",
        accuracy_penalty={"mpsoc_dpu": 0.05},      # QAT'd backbone
        faults=list(faults))


def vision_section(args) -> dict:
    # board-b drops out entirely; half a scrub later the sidecar loses
    # its Edge TPU — the only pool with that profile, so the frontier
    # itself shrinks until the scrub completes
    spec = vision_fleet_spec(faults=[
        FaultSpec("board-b", at_s=args.fault_at,
                  duration_s=args.fault_duration),
        FaultSpec("sidecar", at_s=args.fault_at + args.fault_duration / 2,
                  lost_profiles=("edge_tpu",),
                  duration_s=args.fault_duration),
    ])
    client = spec.build()
    n_before = len(client.router.frontier)
    classes = [SLO_CLASSES["downlink-critical"],
               SLO_CLASSES["realtime-tracking"],
               SLO_CLASSES["background-science"],
               SLO_CLASSES["bulk-reprocess"]]
    open_loop(client, classes, [0.2, 0.3, 0.3, 0.2],
              rate_hz=args.rate, n_requests=args.requests, seed=args.seed)
    snap = client.telemetry
    snap["frontier_plans_initial"] = n_before
    snap["frontier_plans_final"] = len(client.router.frontier)
    snap["frontier_trace"] = [
        {"t": round(t, 3), "plans": n}
        for t, n in client.failover.frontier_sizes]
    snap["fault_events"] = [
        {"kind": e.kind, "pool": e.fault.pool, "at_s": e.at_s}
        for e in client.failover.events]
    return snap


def lm_section(args) -> dict:
    from repro_torch.configs import get_config
    cfg = get_config(args.arch, smoke=True)
    spec = FleetSpec(
        pools=[
            PoolSpec("pod-int8", ("tpu_v5e_int8",),
                     capacity=4, max_window=8),
            PoolSpec("pod-bf16", ("tpu_v5e_bf16",),
                     capacity=4, max_window=8),
            PoolSpec("pod-mixed", ("tpu_v5e_int8", "tpu_v5e_bf16"),
                     capacity=4, max_window=8),
        ],
        workload="transformer", arch=args.arch, seq_len=args.seq,
        cut_candidates=list(range(1, cfg.num_layers)),
        accuracy_penalty={"tpu_v5e_int8": 0.015},
        slos=[dict(name="lm-interactive", max_latency_s=0.05,
                   max_accuracy_penalty=0.02, priority=1),
              dict(name="lm-batch", max_latency_s=1.0, max_energy_j=2.0)],
        faults=[FaultSpec("pod-int8", at_s=args.fault_at,
                          duration_s=args.fault_duration)])
    client = spec.build()
    classes = [client.resolve_slo("lm-interactive"),
               client.resolve_slo("lm-batch")]
    open_loop(client, classes, [0.5, 0.5], rate_hz=args.rate * 4,
              n_requests=args.requests, seed=args.seed)
    return client.telemetry


def lm_execute_section(args) -> dict:
    """Real decode: an LM pool backed by the continuous-batching engine
    (or the windowed baseline with ``--windowed-lm``), routed through
    the facade, on ``args.device``."""
    spec = FleetSpec(
        pools=[PoolSpec("lm-real", ("tpu_v5e_bf16",),
                        backend="windowed" if args.windowed_lm
                        else "engine",
                        capacity=1, max_window=4, max_wait_s=0.0,
                        max_slots=4, prompt_len=16,
                        max_new=args.max_new)],
        workload="transformer", arch=args.arch, seq_len=16,
        slos=[dict(name="lm-offline", max_latency_s=120.0)])
    # build() takes first-use costs out of telemetry
    client = spec.build(device=args.device)
    vocab = client.engines["lm-real"].cfg.vocab_size

    def prompt(r):
        return r.integers(0, vocab, int(r.integers(2, 16))
                          ).astype(np.int32)

    handles = open_loop(client, [client.resolve_slo("lm-offline")], [1.0],
                        rate_hz=50.0,
                        n_requests=min(args.requests, 16),
                        seed=args.seed, dt=0.05, payload_fn=prompt)
    snap = client.telemetry
    snap["generated_tokens"] = sum(len(h.tokens) for h in handles)
    return snap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--rate", type=float, default=40.0,
                    help="open-loop arrival rate, requests/s")
    ap.add_argument("--fault-at", type=float, default=3.0)
    ap.add_argument("--fault-duration", type=float, default=4.0,
                    help="SEU scrub window; inf-like values = permanent")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm", action="store_true",
                    help="also route an LM workload over TPU v5e pools")
    ap.add_argument("--execute-lm", action="store_true",
                    help="route real decodes through an LM server pool")
    ap.add_argument("--windowed-lm", action="store_true",
                    help="--execute-lm with the windowed baseline "
                         "instead of the continuous engine")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true")   # accepted for parity
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--json", action="store_true",
                    help="print raw JSON only (for scripting)")
    ap.add_argument("--device", default="cuda",
                    help="where --execute-lm decodes (the card unless 'cpu')")
    args = ap.parse_args(argv)
    if args.execute_lm:
        require_device(ap, args.device)

    report = {"vision": vision_section(args)}
    if args.lm:
        report["lm_costmodel"] = lm_section(args)
    if args.execute_lm:
        report["lm_real"] = lm_execute_section(args)

    if args.json:
        print(json.dumps(report, indent=2))
        return
    v = report["vision"]
    print(json.dumps(report, indent=2))
    total = v["completed"] + v["dropped"]
    print(f"\nvision fleet: {v['admitted']} admitted / {v['rejected']} "
          f"rejected; {v['completed']} completed, {v['violations']} SLO "
          f"violations ({v['dropped']} dropped); {v['failovers']} failover, "
          f"{v['reschedules']} reschedules "
          f"(frontier {v['frontier_plans_initial']} -> "
          f"{v['frontier_plans_final']} plans)")
    assert total == v["admitted"], "router lost requests"


if __name__ == "__main__":
    main()
