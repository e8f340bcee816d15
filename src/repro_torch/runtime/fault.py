"""Scheduled faults (the port of ``repro.runtime.fault``, serving side).

Serving-side faults (router subsystem): onboard accelerators in space see
SEU-style transient upsets — a device drops out, then (usually) comes back
after a scrub/reset.  ``PoolFault`` / ``PoolFaultInjector`` model this at
pool granularity on the router's clock: at ``at_s`` the named pool loses
``lost_profiles`` (or all of them), and recovers after ``duration_s``
unless the fault is permanent (``duration_s=inf``).

``FaultInjector`` raises at scheduled training steps.  The reference's
``FaultTolerantRunner`` (checkpoint/restart of a training run) belongs to
the training slice of the port (ROADMAP.md, port queue item 11).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple


class FaultInjector:
    def __init__(self, fail_at_steps=(), exc=RuntimeError):
        self.fail_at = set(fail_at_steps)
        self.exc = exc

    def __call__(self, step: int, state, metrics):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise self.exc(f"injected fault at step {step}")


@dataclass(frozen=True)
class PoolFault:
    """One scheduled upset on the router's clock.

    ``kind`` picks the blast radius:

    * ``"pool"`` (default, the original behaviour) — the named pool loses
      ``lost_profiles`` (or everything) and in-flight work fails over.
    * ``"kv_bitflip"`` — a single event upset flips one bit in a live
      paged KV block of the pool's engine; ``seed`` picks the bit.
    * ``"slot_stall"`` — engine slot ``slot`` latches up: the next
      request admitted there makes no decode progress until the fault
      recovers (the watchdog evicts and replays it meanwhile).
    * ``"handoff_loss"`` — the next prefill->decode ``PrefillHandoff``
      payload is dropped at the seam and must be re-requested.
    """
    pool: str
    at_s: float
    lost_profiles: Tuple[str, ...] = ()     # () -> the whole pool drops out
    duration_s: float = math.inf            # finite -> transient (SEU scrub)
    kind: str = "pool"
    slot: int = 0                           # slot_stall target
    seed: int = 0                           # kv_bitflip site selector

    @property
    def transient(self) -> bool:
        return math.isfinite(self.duration_s)


@dataclass(frozen=True)
class PoolFaultEvent:
    kind: str                               # "degrade" | "recover"
    fault: PoolFault
    at_s: float


class PoolFaultInjector:
    """Time-ordered degrade/recover event stream for the serving router.

    ``poll(now)`` returns every event due at or before ``now`` exactly
    once, in time order — the FailoverController consumes them and drives
    pool state + rescheduling.
    """

    def __init__(self, faults: Sequence[PoolFault] = ()):
        self._heap: List[Tuple[float, int, PoolFaultEvent]] = []
        self._n = 0
        for f in faults:
            self.schedule(f)

    def schedule(self, fault: PoolFault) -> None:
        self._push(PoolFaultEvent("degrade", fault, fault.at_s))
        if fault.transient:
            self._push(PoolFaultEvent("recover", fault,
                                      fault.at_s + fault.duration_s))

    def _push(self, ev: PoolFaultEvent) -> None:
        heapq.heappush(self._heap, (ev.at_s, self._n, ev))
        self._n += 1

    def poll(self, now: float) -> List[PoolFaultEvent]:
        due = []
        while self._heap and self._heap[0][0] <= now:
            due.append(heapq.heappop(self._heap)[2])
        return due

    @property
    def pending(self) -> int:
        return len(self._heap)
