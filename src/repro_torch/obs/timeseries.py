"""Fleet time-series: a bounded ring buffer sampled on the virtual clock
(the port's copy of ``repro.obs.timeseries``).

Telemetry snapshots answer "where did the run end up"; this answers
"what did the fleet look like *during* the run" — the signal the orbit
report, the autoscaler tests, and the Chrome-trace counter lanes all
want.  :class:`FleetTimeSeries` is sampled from
``ServingClient.advance`` every clock tick (optionally decimated with
``interval_s``), holds at most ``maxlen`` samples (a ring: old samples
age out, the recorder never grows unbounded on long runs), and derives
rates (tokens/s) from cumulative counters at read time so decimation
never biases them.

Each sample is one small tuple-backed row::

    t            virtual time of the sample
    decode_tokens  cumulative fleet decode tokens (rate derivable)
    queue_depth  fleet queued requests at this instant
    load         queued + in-flight
    occupancy    mean engine slot occupancy (0 for cost-model fleets)
    bucket_frac  orbit battery fraction (None when no controller)
    pools        live pool count (autoscaler growth/retirement visible)
    mode         dispatch mode ("nominal"/"conserve"/"critical")
    alerts       SLO alerts firing at sample time (repro_torch.obs.slo)

``decode_tokens`` is a *sanitized* cumulative: per-pool counters are
differentiated before summing, so counters leaving ``telemetry.pools``
(retirement history compaction) can never step the fleet total backward
and spike ``tokens_per_s`` negative.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class Sample:
    t: float
    decode_tokens: int
    queue_depth: int
    load: int
    occupancy: float
    bucket_frac: Optional[float]
    pools: int
    mode: str
    alerts: int = 0                      # SLO alerts firing at sample time

    def to_dict(self) -> Dict:
        return {"t": round(self.t, 6), "decode_tokens": self.decode_tokens,
                "queue_depth": self.queue_depth, "load": self.load,
                "occupancy": round(self.occupancy, 4),
                "bucket_frac": (None if self.bucket_frac is None
                                else round(self.bucket_frac, 4)),
                "pools": self.pools, "mode": self.mode,
                "alerts": self.alerts}


class FleetTimeSeries:
    """Ring-buffered per-tick fleet samples on the virtual clock."""

    def __init__(self, maxlen: int = 4096, interval_s: float = 0.0):
        self.maxlen = maxlen
        self.interval_s = interval_s
        self.samples: deque = deque(maxlen=maxlen)
        self.total_samples = 0           # including ones the ring aged out
        self._last_t = -float("inf")
        # per-pool decode counters at the last sample: the fleet rate is
        # differentiated per pool *before* summing, so a retired pool's
        # counters leaving telemetry (history compaction) can never make
        # the summed cumulative step backward and spike the rate negative
        self._pool_seen: Dict[str, int] = {}
        self._decode_cum = 0             # sanitized monotone cumulative

    # ------------------------------------------------------------------
    # write side (ServingClient.advance)
    # ------------------------------------------------------------------
    def observe(self, client, now: float) -> bool:
        """Take one sample of ``client`` at virtual time ``now``;
        returns False when decimated away by ``interval_s``."""
        if now - self._last_t < self.interval_s:
            return False
        self._last_t = now
        tel = client.router.telemetry
        queued = load = 0
        for p in client.router.pools.values():
            queued += p.queue_depth
            load += p.load
        current = {name: c.decode_tokens for name, c in tel.pools.items()}
        self._decode_cum += sum(
            max(0, v - self._pool_seen.get(name, 0))
            for name, v in current.items())
        self._pool_seen = current
        engines = client.engines
        occ = (sum(e.occupancy for e in engines.values()) / len(engines)
               if engines else 0.0)
        ctrl = client.controller
        self.samples.append(Sample(
            now, self._decode_cum, queued, load, occ,
            None if ctrl is None else ctrl.bucket.frac,
            len(client.router.pools),
            "nominal" if ctrl is None else ctrl.mode,
            tel.alerts.firing_count))
        self.total_samples += 1
        return True

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.samples)

    def series(self, key: str) -> List:
        """One column over the retained window, e.g.
        ``series("queue_depth")`` or ``series("t")``."""
        return [getattr(s, key) for s in self.samples]

    def tokens_per_s(self) -> List[float]:
        """Decode-token rate between consecutive retained samples (the
        sanitized cumulative counter differentiates cleanly even when
        the ring decimated or aged out samples, and the clamp guarantees
        no negative rate survives whatever the counters did)."""
        out = []
        prev = None
        for s in self.samples:
            if prev is not None and s.t > prev.t:
                out.append(max(0.0, (s.decode_tokens - prev.decode_tokens)
                               / (s.t - prev.t)))
            elif prev is not None:
                out.append(0.0)
            prev = s
        return out

    def summary(self) -> Dict:
        """Compact roll-up for reports (the orbit ``report()`` embeds
        this): retained window, peaks, and terminal values."""
        if not self.samples:
            return {"samples": 0, "retained": 0}
        first, last = self.samples[0], self.samples[-1]
        rates = self.tokens_per_s()
        fracs = [s.bucket_frac for s in self.samples
                 if s.bucket_frac is not None]
        return {
            "samples": self.total_samples,
            "retained": len(self.samples),
            "t0": round(first.t, 6), "t1": round(last.t, 6),
            "queue_depth_peak": max(s.queue_depth for s in self.samples),
            "load_peak": max(s.load for s in self.samples),
            "occupancy_peak": round(max(s.occupancy
                                        for s in self.samples), 4),
            "tokens_per_s_peak": round(max(rates), 2) if rates else 0.0,
            "pools_min": min(s.pools for s in self.samples),
            "pools_max": max(s.pools for s in self.samples),
            "bucket_frac_min": (round(min(fracs), 4) if fracs else None),
            "bucket_frac_last": (round(fracs[-1], 4) if fracs else None),
            "mode_last": last.mode,
            "alerts_peak": max(s.alerts for s in self.samples),
        }

    def to_dict(self) -> Dict:
        return {"interval_s": self.interval_s, "maxlen": self.maxlen,
                "summary": self.summary(),
                "samples": [s.to_dict() for s in self.samples]}
