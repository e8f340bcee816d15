"""Metrics exporters: Prometheus text format + ``SLO_report.json`` (the
port's copy of ``repro.obs.metrics``; the metric names are the
reference's, so the two packages' dumps are byte-equal).

The fleet has no HTTP server (and fleetlint would rightly object to one
inside the virtual-clock world), so the Prometheus side is an
*endpoint-less dump*: :func:`prometheus_text` renders the current
telemetry snapshot — fleet counters, per-pool counters, golden-signal
SLI quantiles, and (when an :class:`~repro_torch.obs.slo.SLOEngine` is
attached) per-objective burn rates, budget remaining, and firing
alerts — in the text exposition format, ready to be written to a file
a node_exporter textfile collector (or a test) can pick up.

:func:`slo_report` is the judgment artifact CI uploads: the SLOSpec,
per-objective evaluation, SLI summaries, alert state and history, and
the fleet time-series summary, all JSON-serializable.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple


def _escape(value) -> str:
    return str(value).replace("\\", r"\\").replace('"', r"\"")


def _render(name: str, mtype: str, help_text: str,
            samples: List[Tuple[Dict[str, str], float]],
            lines: List[str]) -> None:
    if not samples:
        return
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {mtype}")
    for labels, value in samples:
        label_s = ""
        if labels:
            inner = ",".join(f'{k}="{_escape(v)}"'
                             for k, v in labels.items())
            label_s = "{" + inner + "}"
        lines.append(f"{name}{label_s} {value}")


_FLEET_COUNTERS = ("admitted", "rejected", "completed", "violations",
                   "dropped", "failovers", "reschedules", "retries",
                   "watchdog_trips", "bitflips_detected",
                   "blocks_quarantined", "handoffs_replayed",
                   "energy_deferred", "energy_rejected", "pools_added",
                   "pools_retired")
_POOL_COUNTERS = ("dispatched", "completed", "decode_tokens",
                  "prefill_tokens", "evicted", "watchdog_trips")
_SLI_SIGNALS = ("ttft_s", "itl_s", "queue_wait_s", "e2e_s")


def prometheus_text(client) -> str:
    """Render the client's telemetry as Prometheus text exposition."""
    tel = client.router.telemetry
    snap = tel.snapshot()
    lines: List[str] = []

    _render("repro_fleet_events_total", "counter",
            "Fleet lifecycle counters by event.",
            [({"event": k}, snap[k]) for k in _FLEET_COUNTERS
             if k in snap], lines)
    _render("repro_fleet_drops_total", "counter",
            "Dropped requests by reason.",
            [({"reason": k}, v)
             for k, v in sorted(snap["drops_by_reason"].items())], lines)
    _render("repro_fleet_queue_depth", "gauge",
            "Requests queued across the fleet.",
            [({}, snap["queue_depth"])], lines)
    _render("repro_fleet_energy_joules", "gauge",
            "Cumulative fleet energy.", [({}, snap["energy_j"])], lines)

    pool_samples = {c: [] for c in _POOL_COUNTERS}
    for pool, counters in sorted(snap["pools"].items()):
        for c in _POOL_COUNTERS:
            if c in counters:
                pool_samples[c].append(({"pool": pool}, counters[c]))
    for c in _POOL_COUNTERS:
        _render(f"repro_pool_{c}_total", "counter",
                f"Per-pool {c} counter.", pool_samples[c], lines)

    # golden-signal SLI quantiles per scope
    slis = snap["slis"]
    scopes = [({"scope": "fleet"}, slis["fleet"])]
    scopes += [({"scope": "class", "name": k}, v)
               for k, v in sorted(slis["by_class"].items())]
    scopes += [({"scope": "pool", "name": k}, v)
               for k, v in sorted(slis["by_pool"].items())]
    for signal in _SLI_SIGNALS:
        samples = []
        for labels, scope in scopes:
            hist = scope[signal]
            if not hist["count"]:
                continue
            for q in ("p50", "p99"):
                samples.append((dict(labels, quantile=q), hist[q]))
        _render(f"repro_sli_{signal[:-2]}_seconds", "gauge",
                f"Golden-signal {signal} quantiles per scope.",
                samples, lines)

    engine = getattr(client, "slo_engine", None)
    if engine is not None:
        objectives = engine.objectives()
        base = [({"slo_class": o["slo_class"], "objective": o["objective"]},
                 o) for o in objectives]
        _render("repro_slo_burn_rate", "gauge",
                "Fast-window error-budget burn rate per objective.",
                [(lbl, o["burn_fast"]) for lbl, o in base], lines)
        _render("repro_slo_burn_rate_slow", "gauge",
                "Slow-window error-budget burn rate per objective.",
                [(lbl, o["burn_slow"]) for lbl, o in base], lines)
        _render("repro_slo_budget_remaining", "gauge",
                "Fraction of the error budget left per objective.",
                [(lbl, o["budget_remaining"]) for lbl, o in base], lines)
    alerts = snap["alerts"]
    _render("repro_alerts_firing", "gauge",
            "Currently firing SLO alerts.",
            [({"reason": a["reason"], "slo_class": a["slo_class"],
               "severity": a["severity"]}, 1)
             for a in alerts["firing"]] or [({}, 0)], lines)
    _render("repro_alerts_fired_total", "counter",
            "Cumulative alerts fired by severity.",
            [({"severity": "page"}, alerts["pages_fired"]),
             ({"severity": "warn"}, alerts["warns_fired"])], lines)
    return "\n".join(lines) + "\n"


def export_prometheus(client, path: str) -> str:
    """Write :func:`prometheus_text` to ``path``; returns the text."""
    text = prometheus_text(client)
    with open(path, "w") as fh:
        fh.write(text)
    return text


def slo_report(client, t_end: Optional[float] = None) -> Dict:
    """The CI judgment artifact: spec, objectives, SLIs, alerts,
    time-series summary.  JSON-serializable; works without an engine
    attached (``slo`` is then None)."""
    tel = client.router.telemetry
    engine = getattr(client, "slo_engine", None)
    report = {
        "t": round(client.now if t_end is None else t_end, 6),
        "slo": engine.report() if engine is not None else None,
        "telemetry": tel.snapshot(),
    }
    timeseries = getattr(client, "timeseries", None)
    if timeseries is not None:
        report["timeseries"] = timeseries.summary()
    return report


def export_slo_report(client, path: str,
                      t_end: Optional[float] = None) -> Dict:
    """Write :func:`slo_report` to ``path`` as JSON; returns the dict."""
    report = slo_report(client, t_end=t_end)
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return report
