"""Router telemetry: per-pool counters and latency/queue histograms.

The port's copy of ``repro.router.telemetry``.  Everything is plain
Python (no framework) and JSON-serializable via
``snapshot()`` — the same dict feeds the launch demo's report, the
benchmark's output file, and the tests' assertions.  Histograms keep raw
samples rather than buckets, bounded by *reservoir sampling*: beyond
``max_samples`` each new value replaces a uniformly-random retained one
(deterministic seed), so long runs keep an unbiased sample of the whole
run instead of a snapshot of its first N values.  Percentile queries
sort once and reuse the sorted view until the next ``record`` (a
dirty-flag cache — ``snapshot()`` asks for several percentiles per
histogram).
"""
from __future__ import annotations

import random
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Histogram:
    samples: List[float] = field(default_factory=list)
    max_samples: int = 100_000            # bound memory on long runs
    seed: int = 0x5EED                    # reservoir RNG (deterministic)
    _seen: int = field(default=0, repr=False, compare=False)
    _dirty: bool = field(default=True, repr=False, compare=False)
    _sorted: Optional[List[float]] = field(default=None, repr=False,
                                           compare=False)
    _rng: Optional[random.Random] = field(default=None, repr=False,
                                          compare=False)

    def __post_init__(self):
        self._seen = len(self.samples)

    def record(self, v: float) -> None:
        """Record one sample.  Past ``max_samples`` the reservoir kicks
        in (Vitter's algorithm R): the new value replaces a uniformly
        random retained one with probability ``max_samples/seen``, so
        p50/p99 stay representative of the *whole* run — the old
        keep-the-first-N policy biased every percentile toward run
        start the moment the bound was hit."""
        self._seen += 1
        self._dirty = True
        if len(self.samples) < self.max_samples:
            self.samples.append(float(v))
            return
        if self._rng is None:
            self._rng = random.Random(self.seed)
        j = self._rng.randrange(self._seen)
        if j < self.max_samples:
            self.samples[j] = float(v)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        if (self._dirty or self._sorted is None
                or len(self._sorted) != len(self.samples)):
            self._sorted = sorted(self.samples)
            self._dirty = False
        s = self._sorted
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    @property
    def count(self) -> int:
        """Samples *recorded* (dropped ones included)."""
        return self._seen

    @property
    def dropped(self) -> int:
        """Samples recorded but not retained by the reservoir."""
        return self._seen - len(self.samples)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean": round(self.mean, 6),
                "p50": round(self.percentile(50), 6),
                "p99": round(self.percentile(99), 6),
                "dropped": self.dropped}


@dataclass
class PoolCounters:
    dispatched: int = 0                   # requests routed to the pool
    completed: int = 0
    evicted: int = 0                      # displaced by a fault
    batches: int = 0
    energy_j: float = 0.0                 # cost-model energy estimate
    busy_s: float = 0.0                   # time spent executing batches
    tokens_generated: int = 0             # LM pools: real sampled tokens
    decode_tokens: int = 0                # tokens from decode steps only
    decode_s: float = 0.0                 # wall time inside decode steps
    prefill_tokens: int = 0               # prompt tokens prefilled here
    deferrals: int = 0                    # OutOfBlocks admission deferrals
    queue_depth_now: int = 0              # live queue depth (this instant)
    load_now: int = 0                     # live queued + in-flight
    bitflips_detected: int = 0            # KV checksum mismatches caught
    blocks_quarantined: int = 0           # KV blocks pulled from service
    watchdog_trips: int = 0               # stalled slots evicted
    handoffs_replayed: int = 0            # lost/corrupt handoffs re-run
    prefix_hits: int = 0                  # prompt blocks served by the
                                          # content-hash prefix index
    prefix_lookups: int = 0               # prompt blocks offered to it
    # sharded decode pools: handoff imports per consumer shard
    imports_by_shard: Dict[str, int] = field(default_factory=dict)
    queue_depth: Histogram = field(default_factory=Histogram)
    batch_size: Histogram = field(default_factory=Histogram)
    slot_occupancy: Histogram = field(default_factory=Histogram)

    @property
    def tokens_per_s(self) -> float:
        """Throughput over time spent executing batches end-to-end
        (prefill, admission stalls, and decode all included)."""
        return self.tokens_generated / self.busy_s if self.busy_s else 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        """Decode-only throughput: sampled decode tokens over wall time
        inside decode steps — the number ``benchmarks/decode_bench.py``
        reports, free of prefill-window idle time and prompt tokens."""
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of offered prompt blocks served from the shared
        prefix index (0.0 when the pool never offered one)."""
        return (self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0)

    def summary(self) -> Dict:
        return {"dispatched": self.dispatched, "completed": self.completed,
                "evicted": self.evicted, "batches": self.batches,
                "energy_j": round(self.energy_j, 4),
                "busy_s": round(self.busy_s, 4),
                "tokens_generated": self.tokens_generated,
                "tokens_per_s": round(self.tokens_per_s, 2),
                "decode_tokens": self.decode_tokens,
                "decode_s": round(self.decode_s, 4),
                "decode_tokens_per_s": round(self.decode_tokens_per_s, 2),
                "prefill_tokens": self.prefill_tokens,
                "deferrals": self.deferrals,
                "queue_depth_now": self.queue_depth_now,
                "load_now": self.load_now,
                "bitflips_detected": self.bitflips_detected,
                "blocks_quarantined": self.blocks_quarantined,
                "watchdog_trips": self.watchdog_trips,
                "handoffs_replayed": self.handoffs_replayed,
                "prefix_hits": self.prefix_hits,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hit_rate": round(self.prefix_hit_rate, 4),
                "imports_by_shard": dict(sorted(
                    self.imports_by_shard.items())),
                "queue_depth": self.queue_depth.summary(),
                "batch_size": self.batch_size.summary(),
                "slot_occupancy": self.slot_occupancy.summary()}


class Telemetry:
    """One instance per Router; pools and the failover controller write
    into it, reports read from it.

    Also hosts the fleet's flight recorder: ``tracer`` is the one
    :class:`~repro_torch.obs.trace.Tracer` every layer shares (disabled by
    default — span recording costs one attribute check until
    ``ServingClient.enable_tracing()`` flips it on)."""

    def __init__(self):
        # local: obs imports telemetry
        from repro_torch.obs.trace import Tracer
        from repro_torch.obs.slo import AlertBus, SLIRegistry
        self.tracer = Tracer()
        # golden-signal SLIs + SLO alert state: always constructed so
        # snapshot()["slis"] / ["alerts"] have a stable shape whether or
        # not an SLOSpec is ever attached
        self.slis = SLIRegistry()
        self.alerts = AlertBus()
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.violations = 0
        self.dropped = 0                  # admitted but unservable (no pool)
        # why admitted requests were dropped, zero-initialized so the
        # snapshot schema is stable whether or not a reason ever fires
        self.drops_by_reason: Dict[str, int] = {
            "no_route": 0, "retry_exhausted": 0, "dry_battery": 0,
            "deadline": 0}
        self.failovers = 0
        self.reschedules = 0
        self.retries = 0                  # bounded redispatch attempts
        self.watchdog_trips = 0           # client-level no-progress trips
        self.energy_deferred = 0          # parked by the orbit energy cap
        self.energy_rejected = 0          # rejected with the battery dry
        self.pools_added = 0              # autoscaler / live growth events
        self.pools_retired = 0            # graceful retirements completed
        self.pools: Dict[str, PoolCounters] = defaultdict(PoolCounters)
        self.latency_by_class: Dict[str, Histogram] = defaultdict(Histogram)
        self.violations_by_class: Dict[str, int] = defaultdict(int)

    def pool(self, name: str) -> PoolCounters:
        return self.pools[name]

    def record_completion(self, slo_name: str, latency_s: float,
                          violated: bool, *, t: Optional[float] = None,
                          pool: Optional[str] = None,
                          ttft_s: Optional[float] = None,
                          itl_s: Optional[float] = None,
                          queue_wait_s: Optional[float] = None) -> None:
        self.completed += 1
        self.latency_by_class[slo_name].record(latency_s)
        if violated:
            self.violations += 1
            self.violations_by_class[slo_name] += 1
        if t is not None:
            # same terminal path that closes the span chain also feeds
            # the golden-signal SLIs — no second instrumentation layer
            self.slis.observe_completion(t, slo_name, pool, latency_s,
                                         ttft_s=ttft_s, itl_s=itl_s,
                                         queue_wait_s=queue_wait_s,
                                         violated=violated)

    def record_rejection(self, slo_name: str, t: float) -> None:
        """Admission-time rejection (router gate or dry-battery energy
        gate): one counter bump plus the SLI/burn-window event."""
        self.rejected += 1
        self.slis.observe_reject(t, slo_name)

    def record_drop(self, slo_name: str, reason: str = "no_route",
                    admitted: bool = True, *, t: Optional[float] = None,
                    pool: Optional[str] = None) -> None:
        """Count one dropped request under its reason code.  A drop at
        the admission gate itself (``admitted=False`` — e.g. dry-battery
        rejection) keeps the reason ledger without inflating the
        admitted-request ``dropped`` counter the accounting invariant
        (admitted == completed + dropped) is checked against."""
        self.drops_by_reason[reason] = (
            self.drops_by_reason.get(reason, 0) + 1)
        if not admitted:
            return
        self.dropped += 1
        self.violations += 1
        self.violations_by_class[slo_name] += 1
        if t is not None:
            self.slis.observe_drop(t, slo_name, pool)

    def snapshot(self) -> Dict:
        return {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "violations": self.violations,
            "dropped": self.dropped,
            "drops_by_reason": dict(sorted(self.drops_by_reason.items())),
            "failovers": self.failovers,
            "reschedules": self.reschedules,
            "retries": self.retries,
            "watchdog_trips": self.watchdog_trips,
            # fleet-wide hardening aggregates (sums of the per-pool
            # counters, so a dashboard needs one read)
            "bitflips_detected": sum(p.bitflips_detected
                                     for p in self.pools.values()),
            "blocks_quarantined": sum(p.blocks_quarantined
                                      for p in self.pools.values()),
            "handoffs_replayed": sum(p.handoffs_replayed
                                     for p in self.pools.values()),
            # prefix-sharing efficiency across the fleet: hit rate of
            # the content-hash block index (pooled, not averaged)
            "prefix_hits": sum(p.prefix_hits for p in self.pools.values()),
            "prefix_hit_rate": round(
                (sum(p.prefix_hits for p in self.pools.values())
                 / max(1, sum(p.prefix_lookups
                              for p in self.pools.values()))), 4),
            "energy_deferred": self.energy_deferred,
            "energy_rejected": self.energy_rejected,
            "pools_added": self.pools_added,
            "pools_retired": self.pools_retired,
            # fleet-wide aggregates: the one schema the orbit controller
            # and external monitors read (retired pools included, so
            # energy_j is the cumulative orbit spend)
            "energy_j": round(sum(p.energy_j for p in self.pools.values()),
                              4),
            "queue_depth": sum(p.queue_depth_now
                               for p in self.pools.values()),
            "pools": {k: v.summary() for k, v in sorted(self.pools.items())},
            "latency_by_class": {k: v.summary() for k, v in
                                 sorted(self.latency_by_class.items())},
            "violations_by_class": dict(sorted(
                self.violations_by_class.items())),
            # golden-signal SLIs + SLO alert state (repro_torch.obs.slo)
            "slis": self.slis.summary(),
            "alerts": self.alerts.snapshot(),
        }
