"""repro_torch.obs — the flight recorder and the SLO plane over the
serving stack (the port's copy of ``repro.obs``).

* :mod:`repro_torch.obs.trace` — per-request span trees on the fleet's
  virtual clock, recorded by hooks threaded through ``ServingClient``,
  ``Router``, ``AcceleratorPool``, ``EngineExecutor``, the engines and the
  orbit ``FleetController``.  Read one back with
  ``ResponseHandle.trace()``.
* :mod:`repro_torch.obs.timeseries` — a bounded ring buffer of per-tick
  fleet samples (tokens/s, queue depth, occupancy, bucket level, pool
  count, mode, firing alerts).
* :mod:`repro_torch.obs.slo` — golden-signal SLIs (TTFT, inter-token
  latency, queue wait, e2e latency, drop/retry rates; per pool and per
  SLO class), declarative :class:`SLOSpec` objectives with error budgets,
  multi-window burn-rate alerting, and the :class:`AlertBus`.
* :mod:`repro_torch.obs.metrics` — Prometheus text-format dump and the
  ``SLO_report.json`` judgment artifact.
* :mod:`repro_torch.obs.export` — spans to JSONL and to Chrome
  ``trace_event`` JSON (one lane per pool/stage, orbit phases as async
  spans, SLI/alert counter tracks), viewable in Perfetto.

Both dumps are the reference's formats: the same metric names, events
and keys, so a port fleet's exports compare equal to the reference's.
"""
from repro_torch.obs.export import (chrome_trace, export_chrome_trace,
                                    export_spans_jsonl)
from repro_torch.obs.metrics import (export_prometheus, export_slo_report,
                                     prometheus_text, slo_report)
from repro_torch.obs.slo import (REASON_CODES, Alert, AlertBus, SLIRegistry,
                                 SLIScope, SLOEngine, SLOObjective, SLOSpec)
from repro_torch.obs.timeseries import FleetTimeSeries, Sample
from repro_torch.obs.trace import OUTCOMES, Span, Tracer

__all__ = ["Alert", "AlertBus", "FleetTimeSeries", "OUTCOMES",
           "REASON_CODES", "SLIRegistry", "SLIScope", "SLOEngine",
           "SLOObjective", "SLOSpec", "Sample", "Span", "Tracer",
           "chrome_trace", "export_chrome_trace", "export_prometheus",
           "export_slo_report", "export_spans_jsonl", "prometheus_text",
           "slo_report"]
