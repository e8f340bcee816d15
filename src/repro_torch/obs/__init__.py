"""repro_torch.obs — the flight recorder and the SLO plane over the
serving stack (the port's copy of ``repro.obs``, three of its five
layers).

* :mod:`repro_torch.obs.trace` — per-request span trees on the fleet's
  virtual clock, recorded by hooks threaded through ``ServingClient``,
  ``Router``, ``AcceleratorPool``, ``EngineExecutor`` and the engines.
  Read one back with ``ResponseHandle.trace()``.
* :mod:`repro_torch.obs.timeseries` — a bounded ring buffer of per-tick
  fleet samples (tokens/s, queue depth, occupancy, pool count, mode,
  firing alerts).
* :mod:`repro_torch.obs.slo` — golden-signal SLIs (TTFT, inter-token
  latency, queue wait, e2e latency, drop/retry rates; per pool and per
  SLO class), declarative :class:`SLOSpec` objectives with error budgets,
  multi-window burn-rate alerting, and the :class:`AlertBus`.

The reference's Prometheus and SLO-report dump (``repro.obs.metrics``)
and its JSONL / Chrome-trace exporters (``repro.obs.export``) are not
ported yet (ROADMAP.md, port queue item 7).
"""
from repro_torch.obs.slo import (REASON_CODES, Alert, AlertBus, SLIRegistry,
                                 SLIScope, SLOEngine, SLOObjective, SLOSpec)
from repro_torch.obs.timeseries import FleetTimeSeries, Sample
from repro_torch.obs.trace import OUTCOMES, Span, Tracer

__all__ = ["Alert", "AlertBus", "FleetTimeSeries", "OUTCOMES",
           "REASON_CODES", "SLIRegistry", "SLIScope", "SLOEngine",
           "SLOObjective", "SLOSpec", "Sample", "Span", "Tracer"]
