"""Trace export: spans -> JSONL and Chrome ``trace_event`` JSON (the port's
copy of ``repro.obs.export``: the same events, in the same order, so a
port fleet's trace equals the reference's as parsed JSON).

The Chrome format (one JSON object with a ``traceEvents`` list) loads
directly into Perfetto / ``chrome://tracing``:

* one *process* lane per pool (stage pools like ``lm.prefill``
  included), plus a ``fleet`` lane for router-level events;
* one *thread* row per stage inside each pool lane (queue / serve /
  admit / prefill_chunk / decode_step / handoff / import), so the
  co-processing pipeline reads left-to-right like the MPAI block
  diagram;
* orbit phases (sunlit/eclipse) as *async* spans on the fleet lane,
  with dispatch-mode changes as instant markers;
* the fleet time-series as counter tracks (queue depth, battery
  fraction, decode tokens/s).

All timestamps are the fleet's virtual clock in microseconds — the unit
the format requires — so a 2 ms tick renders as 2000 us regardless of
how long the host actually took.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

_FLEET = "fleet"


def _lane_ids(tracer) -> Dict[str, int]:
    """Stable pid assignment: fleet first, then pools sorted by name."""
    pools = sorted({sp.pool for sp in tracer.spans if sp.pool is not None})
    lanes = {_FLEET: 0}
    for i, p in enumerate(pools):
        lanes[p] = i + 1
    return lanes


def chrome_trace(tracer, timeseries=None, profile=None,
                 t_end: Optional[float] = None, slo=None) -> Dict:
    """Build the Chrome ``trace_event`` dict from a
    :class:`~repro_torch.obs.trace.Tracer` (plus, optionally, the fleet
    time-series and the orbit power profile for phase lanes, and the
    :class:`~repro_torch.obs.slo.SLOEngine` for burn-rate counter tracks)."""
    lanes = _lane_ids(tracer)
    events: List[Dict] = []
    tids: Dict[tuple, int] = {}

    def tid_of(pid: int, stage: str) -> int:
        key = (pid, stage)
        if key not in tids:
            tids[key] = sum(1 for k in tids if k[0] == pid) + 1
            events.append({"ph": "M", "pid": pid, "tid": tids[key],
                           "name": "thread_name",
                           "args": {"name": stage}})
        return tids[key]

    for name, pid in lanes.items():
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": name}})
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_sort_index",
                       "args": {"sort_index": pid}})

    latest = 0.0
    for sp in tracer.spans:
        pid = lanes.get(sp.pool, 0)
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        latest = max(latest, t1)
        args = {k: v for k, v in sp.attrs.items()}
        if sp.rid is not None:
            args["rid"] = sp.rid
        ev = {"name": sp.stage, "cat": sp.stage,
              "pid": pid, "tid": tid_of(pid, sp.stage),
              "ts": round(sp.t0 * 1e6, 3), "args": args}
        if t1 > sp.t0:
            ev["ph"] = "X"
            ev["dur"] = round((t1 - sp.t0) * 1e6, 3)
        else:                                   # instant marker
            ev["ph"] = "i"
            ev["s"] = "p"
        events.append(ev)

    end = t_end if t_end is not None else latest
    if profile is not None and end > 0:
        # orbit phases as async spans on the fleet lane: walk the cyclic
        # profile from t=0 to the end of the trace
        t, k = 0.0, 0
        while t < end:
            ph = profile.phase_at(t)
            t1 = min(t + ph.duration_s, end)
            events.append({"ph": "b", "cat": "orbit", "id": k,
                           "name": ph.name, "pid": 0, "tid": 0,
                           "ts": round(t * 1e6, 3),
                           "args": {"power_w": ph.power_w}})
            events.append({"ph": "e", "cat": "orbit", "id": k,
                           "name": ph.name, "pid": 0, "tid": 0,
                           "ts": round(t1 * 1e6, 3), "args": {}})
            t, k = t1, k + 1

    if timeseries is not None and len(timeseries):
        rates = timeseries.tokens_per_s()
        for i, s in enumerate(timeseries.samples):
            ts = round(s.t * 1e6, 3)
            events.append({"ph": "C", "pid": 0, "tid": 0, "ts": ts,
                           "name": "queue_depth",
                           "args": {"queued": s.queue_depth}})
            events.append({"ph": "C", "pid": 0, "tid": 0, "ts": ts,
                           "name": "decode_tokens_per_s",
                           "args": {"tok/s": round(rates[i - 1], 2)
                                    if i else 0.0}})
            if s.bucket_frac is not None:
                events.append({"ph": "C", "pid": 0, "tid": 0, "ts": ts,
                               "name": "bucket_frac",
                               "args": {"frac": round(s.bucket_frac, 4)}})
            events.append({"ph": "C", "pid": 0, "tid": 0, "ts": ts,
                           "name": "alerts_firing",
                           "args": {"firing": getattr(s, "alerts", 0)}})

    if slo is not None:
        # SLO engine counter tracks: worst fast-window burn rate and the
        # tightest objective's budget remaining, from the per-tick ring
        for t, worst_burn, _, budget_min in slo.history:
            ts = round(t * 1e6, 3)
            events.append({"ph": "C", "pid": 0, "tid": 0, "ts": ts,
                           "name": "slo_burn_fast",
                           "args": {"burn": round(worst_burn, 3)}})
            events.append({"ph": "C", "pid": 0, "tid": 0, "ts": ts,
                           "name": "slo_budget_min",
                           "args": {"frac": round(budget_min, 4)}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            # the reference's source tag: both packages write one format
            "otherData": {"source": "repro.obs flight recorder",
                          "spans": len(tracer.spans),
                          "dropped_spans": tracer.dropped}}


def export_chrome_trace(client, path, t_end: Optional[float] = None) -> Dict:
    """Write ``client``'s flight-recorder state as Chrome trace JSON.

    Pulls the tracer, the time-series, and (when an orbit controller is
    attached) the power profile off the client, so launch demos and
    benchmarks are a one-liner.  Returns the trace dict."""
    ctrl = getattr(client, "controller", None)
    profile = None
    if ctrl is not None and getattr(ctrl, "spec", None) is not None:
        prof_fn = getattr(ctrl.spec, "profile", None)
        profile = prof_fn() if callable(prof_fn) else None
    trace = chrome_trace(client.tracer, timeseries=client.timeseries,
                         profile=profile,
                         t_end=client.now if t_end is None else t_end,
                         slo=getattr(client, "slo_engine", None))
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def export_spans_jsonl(client, path) -> int:
    """Write the client's spans as JSONL; returns the span count."""
    return client.tracer.to_jsonl(path)
