"""Flight-recorder span tracing: one span tree per request (the port's
copy of ``repro.obs.trace``).

The :class:`Tracer` is the fleet's black box.  Every request that enters
:meth:`~repro_torch.serving.client.ServingClient.submit` opens a root
``request`` span; the data and control plane close the chain around it::

    submit -> queue -> [admit | prefill_chunk*] -> [handoff -> import]
           -> serve (one per routed batch) -> complete | reject | drop
    submit -> defer -> queue -> ...            (orbit energy deferral)

Spans live on the fleet's *virtual* clock (the same clock telemetry,
the orbit bucket, and the traffic generator share), so a seeded run
produces a bit-identical trace on any machine; engine-internal detail
(per-chunk prefill, per-step decode batches) is measured in wall time
and anchored at the virtual instant its routed batch launched, so the
two timelines nest coherently in one view.

Design constraints, in order:

1. **Zero overhead off.**  ``enabled`` is False by default and every
   recording method returns immediately; the engines' ``on_stage`` hook
   is only installed while a traced batch runs.
2. **No orphan spans.**  Every terminal event (completion, rejection,
   drop, eviction) closes the request's open spans through
   :meth:`end_request`; ``open_spans()`` after a drained run is the
   test-enforced invariant.
3. **Bounded memory.**  ``max_spans`` caps the record; further spans
   are counted in ``dropped`` rather than silently discarded, and
   already-open spans still close so invariant 2 survives the cap.

One tracer per fleet: it lives on
:class:`~repro_torch.router.telemetry.Telemetry` (the shared observability
bag every layer already holds), and
``ResponseHandle.trace()`` / :mod:`repro_torch.obs.export` read it back out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: Terminal outcomes a request chain can close with.
OUTCOMES = ("completed", "rejected", "energy_rejected", "dropped")


@dataclass
class Span:
    """One timed stage of one request (or a fleet-lane event)."""
    sid: int
    rid: Optional[int]                 # None -> fleet/pool lane span
    stage: str
    t0: float
    t1: Optional[float] = None         # None while open
    pool: Optional[str] = None
    attrs: Dict = field(default_factory=dict)

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> Dict:
        return {"sid": self.sid, "rid": self.rid, "stage": self.stage,
                "t0": round(self.t0, 9),
                "t1": None if self.t1 is None else round(self.t1, 9),
                "pool": self.pool, "attrs": dict(self.attrs)}


class Tracer:
    """Per-request span recorder over the fleet's virtual clock.

    Disabled by default: every method is a cheap no-op until
    ``enabled`` flips True (``ServingClient.enable_tracing()``), so the
    serving hot path pays one attribute check per instrumentation
    point.
    """

    def __init__(self, enabled: bool = False, max_spans: int = 200_000):
        self.enabled = enabled
        self.max_spans = max_spans
        self.spans: List[Span] = []
        self.dropped = 0               # spans lost to the max_spans cap
        self.outcomes: Dict[int, str] = {}
        self._by_rid: Dict[int, List[Span]] = {}
        self._open: Dict[int, Dict[str, Span]] = {}   # rid -> stage -> span
        self._next_sid = 0

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _new(self, rid: Optional[int], stage: str, t0: float,
             t1: Optional[float], pool: Optional[str],
             attrs: Dict) -> Optional[Span]:
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return None
        sp = Span(self._next_sid, rid, stage, t0, t1, pool, attrs)
        self._next_sid += 1
        self.spans.append(sp)
        if rid is not None:
            self._by_rid.setdefault(rid, []).append(sp)
        return sp

    def begin_request(self, rid: int, t: float, **attrs) -> None:
        """Open the root ``request`` span (the chain's anchor)."""
        if not self.enabled:
            return
        self.begin(rid, "request", t, **attrs)

    def begin(self, rid: int, stage: str, t: float,
              pool: Optional[str] = None, **attrs) -> None:
        """Open one stage span for ``rid``.  At most one span per
        (rid, stage) is open at a time; a stale open one (e.g. a queue
        span whose pool was destroyed without an eviction event) is
        closed defensively at ``t`` so chains can never leak."""
        if not self.enabled:
            return
        open_stages = self._open.setdefault(rid, {})
        stale = open_stages.pop(stage, None)
        if stale is not None:
            stale.t1 = t
            stale.attrs.setdefault("truncated", True)
        sp = self._new(rid, stage, t, None, pool, attrs)
        if sp is not None:
            open_stages[stage] = sp

    def finish(self, rid: int, stage: str, t: float, **attrs) -> None:
        """Close the open (rid, stage) span; no-op when none is open."""
        if not self.enabled:
            return
        sp = self._open.get(rid, {}).pop(stage, None)
        if sp is not None:
            sp.t1 = t
            sp.attrs.update(attrs)

    def add(self, rid: Optional[int], stage: str, t0: float, t1: float,
            pool: Optional[str] = None, **attrs) -> None:
        """Record an already-closed span (both endpoints known)."""
        if not self.enabled:
            return
        self._new(rid, stage, t0, t1, pool, attrs)

    def event(self, stage: str, t: float, rid: Optional[int] = None,
              pool: Optional[str] = None, **attrs) -> None:
        """Record an instant marker (duration-0 span)."""
        if not self.enabled:
            return
        self._new(rid, stage, t, t, pool, attrs)

    def end_request(self, rid: int, t: float, outcome: str,
                    **attrs) -> None:
        """Terminal event: record ``outcome`` and close the whole chain
        — the root span and anything still open — at ``t``.  Every exit
        path (completion, rejection, drop) funnels through here, which
        is what makes "no orphan spans" enforceable."""
        if not self.enabled:
            return
        open_stages = self._open.pop(rid, {})
        root = open_stages.pop("request", None)
        for sp in open_stages.values():       # e.g. queue span of a drop
            sp.t1 = t
            sp.attrs.setdefault("truncated", True)
        if root is not None:
            root.t1 = t
            root.attrs.update(attrs)
            root.attrs["outcome"] = outcome
        self.outcomes[rid] = outcome

    # ------------------------------------------------------------------
    # read-back
    # ------------------------------------------------------------------
    @property
    def request_ids(self) -> List[int]:
        return sorted(self._by_rid)

    def spans_for(self, rid: int) -> List[Span]:
        return list(self._by_rid.get(rid, []))

    def open_spans(self) -> List[Span]:
        """Spans still open — empty after a drained run (the orphan
        invariant the test suite locks in)."""
        return [sp for stages in self._open.values()
                for sp in stages.values()]

    def closed(self, rid: int) -> bool:
        """Is this request's chain fully closed (terminal outcome seen,
        no open spans)?"""
        return rid in self.outcomes and not self._open.get(rid)

    def trace(self, rid: int) -> Optional[Dict]:
        """The request's span tree: the root ``request`` span with every
        other span nested under the innermost span whose interval
        contains it (prefill chunks nest under their serve span, etc.).
        Returns None when the rid was never traced."""
        spans = self._by_rid.get(rid)
        if not spans:
            return None
        root = next((s for s in spans if s.stage == "request"), spans[0])
        nodes = {s.sid: {**s.to_dict(), "children": []} for s in spans}
        rest = sorted((s for s in spans if s.sid != root.sid),
                      key=lambda s: (s.t0, -(s.t1 if s.t1 is not None
                                             else s.t0)))
        stack = [root]

        def _end(s: Span) -> float:
            return s.t1 if s.t1 is not None else float("inf")

        for s in rest:
            while len(stack) > 1 and not (stack[-1].t0 <= s.t0
                                          and _end(s) <= _end(stack[-1])):
                stack.pop()
            nodes[stack[-1].sid]["children"].append(nodes[s.sid])
            stack.append(s)
        out = nodes[root.sid]
        out["outcome"] = self.outcomes.get(rid)
        return out

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_jsonl(self, path) -> int:
        """One span per line (creation order); returns the line count."""
        import json
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps(sp.to_dict()) + "\n")
        return len(self.spans)

    def summary(self) -> Dict:
        return {"spans": len(self.spans), "dropped": self.dropped,
                "requests": len(self._by_rid),
                "open": len(self.open_spans()),
                "outcomes": {o: sum(1 for v in self.outcomes.values()
                                    if v == o)
                             for o in sorted(set(self.outcomes.values()))}}
