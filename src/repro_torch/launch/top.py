"""Fleet health plane: a ``top``-style text dashboard over the SLO engine
(the port of ``repro.launch.top``).

    PYTHONPATH=src python -m repro_torch.launch.top          # live frames
    PYTHONPATH=src python -m repro_torch.launch.top --every 0.5
    PYTHONPATH=src python -m repro_torch.launch.top --json   # final report

Drives the canonical vision fleet (``launch/route.py``) through the
eclipse power cycle (``launch/orbit.py``) with an :class:`SLOSpec`
attached, rendering a frame every ``--every`` *virtual* seconds: mode
and battery, per-class golden signals (TTFT / ITL / queue wait / e2e),
per-objective burn rates and error budgets, and the firing alerts.

Everything runs on the fleet's virtual clock — frames are paced by
simulated time, never wall-clock sleeps, so a seed reproduces the
identical frame sequence on any machine.  :func:`render` is a pure
``client -> str`` function; point it at any live ``ServingClient``
(orbit controller and SLO engine optional) to get the same view.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.orbit import MIX, eclipse_orbit_spec, mix_demand_w
from repro_torch.launch.route import vision_fleet_spec
from repro_torch.obs import SLOObjective, SLOSpec
from repro_torch.router import SLO_CLASSES
from repro_torch.serving.traffic import poisson_arrivals

_BAR_W = 16


def _bar(frac: float, width: int = _BAR_W) -> str:
    frac = min(max(frac, 0.0), 1.0)
    fill = int(round(frac * width))
    return "#" * fill + "." * (width - fill)


def _ms(hist: dict, key: str = "p99") -> str:
    v = hist.get(key)
    return "     -" if not hist.get("count") or v is None else f"{v * 1e3:6.1f}"


def render(client) -> str:
    """One dashboard frame for any live fleet — pure, no side effects."""
    snap = client.telemetry
    lines = []

    # -- header: clock, mode, battery, fleet-level counters ------------
    ctrl = getattr(client, "controller", None)
    head = f"t={client.now:8.3f}s  pools={len(client.router.pools)}"
    if ctrl is not None:
        frac = ctrl.bucket.level_j / ctrl.bucket.capacity_j
        head += (f"  mode={ctrl.mode:<8s}  battery [{_bar(frac)}] "
                 f"{100 * frac:5.1f}%")
        if ctrl.storm:
            head += "  STORM"
    lines.append(head)
    lines.append(f"admitted={snap['admitted']}  completed={snap['completed']}"
                 f"  rejected={snap['rejected']}  dropped={snap['dropped']}"
                 f"  violations={snap['violations']}"
                 f"  queue={snap['queue_depth']}"
                 f"  energy={snap['energy_j']:.2f}J")

    # -- golden signals per SLO class ----------------------------------
    lines.append("")
    lines.append(f"{'class':<20s} {'done':>6s} {'drop':>5s} {'viol':>5s} "
                 f"{'ttft p99':>8s} {'itl p99':>8s} {'wait p99':>8s} "
                 f"{'e2e p99':>8s}  (ms)")
    by_class = snap["slis"]["by_class"]
    for name in sorted(by_class):
        s = by_class[name]
        lines.append(f"{name:<20s} {s['completed']:>6d} {s['dropped']:>5d} "
                     f"{s['violated']:>5d} {_ms(s['ttft_s']):>8s} "
                     f"{_ms(s['itl_s']):>8s} {_ms(s['queue_wait_s']):>8s} "
                     f"{_ms(s['e2e_s']):>8s}")
    if not by_class:
        lines.append("(no completions yet)")

    # -- SLO objectives: burn rates and error budgets ------------------
    engine = getattr(client, "slo_engine", None)
    if engine is not None:
        lines.append("")
        lines.append(f"{'objective':<34s} {'burn 1x':>8s} {'burn 5x':>8s} "
                     f"{'budget':>18s}  state")
        for o in engine.objectives(client.now):
            state = ("PAGE" if o["page"]
                     else "warn" if o["warn"] else "ok")
            rem = o["budget_remaining"]
            name = f"{o['slo_class']}/{o['objective']}"
            lines.append(f"{name:<34s} {o['burn_fast']:>8.2f} "
                         f"{o['burn_slow']:>8.2f} "
                         f"[{_bar(rem)}] {100 * rem:4.0f}%  {state}")

    # -- firing alerts -------------------------------------------------
    alerts = snap["alerts"]
    if alerts["firing"]:
        lines.append("")
        for a in alerts["firing"]:
            lines.append(f"!! {a['severity'].upper():<4s} {a['reason']} "
                         f"class={a['slo_class']} "
                         f"burn={a['burn_fast']:.1f}/{a['burn_slow']:.1f} "
                         f"since t={a['t_fired']:.3f}s")
    return "\n".join(lines)


def health_slo_spec() -> SLOSpec:
    """Objectives for the demo mix, tight enough that the eclipse's
    deferral backlog visibly burns budget on the offline classes."""
    return SLOSpec(objectives=[
        SLOObjective("downlink-critical", p99_e2e_s=0.5,
                     availability=0.999),
        SLOObjective("background-science", p99_e2e_s=2.0,
                     availability=0.99),
        SLOObjective("bulk-reprocess", availability=0.95),
    ], fast_window_s=1.0, slow_window_s=5.0, page_burn=10.0,
        warn_burn=2.0, min_events=5)


def run_dashboard(n_requests: int = 300, rate_hz: float = 60.0,
                  seed: int = 0, every_s: float = 1.0,
                  emit=print) -> dict:
    """The eclipse scenario with frames emitted on the virtual clock."""
    spec = vision_fleet_spec()
    spec.slo = health_slo_spec()
    client = spec.build()
    eclipse_orbit_spec(mix_demand_w(client, rate_hz)).attach(client)

    classes = [SLO_CLASSES[n] for n, _ in MIX]
    weights = [w for _, w in MIX]
    arrivals = poisson_arrivals(classes, weights, rate_hz, n_requests,
                                seed=seed)
    i, frames, next_frame = 0, 0, 0.0
    while i < len(arrivals) or client.outstanding or client.pending_faults:
        client.advance()
        while i < len(arrivals) and arrivals[i][0] <= client.now:
            at, slo, payload = arrivals[i]
            client.submit(payload, slo=slo, arrival=at)
            i += 1
        client.pump()
        if client.now >= next_frame:
            emit(render(client))
            emit("")
            frames += 1
            next_frame = client.now + every_s
        if client.now > 600.0:           # safety net: never loop forever
            break
    for _ in range(300):                 # idle tail: drain + age alerts
        client.step()
    emit(render(client))
    report = client.slo_engine.report()
    report["frames"] = frames + 1
    report["t_end_s"] = round(client.now, 3)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=300)
    ap.add_argument("--rate", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--every", type=float, default=1.0, metavar="VIRT_S",
                    help="frame period in virtual seconds")
    ap.add_argument("--json", action="store_true",
                    help="suppress frames, print the final SLO report")
    args = ap.parse_args(argv)

    emit = (lambda *_: None) if args.json else print
    report = run_dashboard(n_requests=args.requests, rate_hz=args.rate,
                           seed=args.seed, every_s=args.every, emit=emit)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
