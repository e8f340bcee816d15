"""SLO engine: golden-signal SLIs, error budgets, burn-rate alerts (the
port's copy of ``repro.obs.slo``).

Beside the flight recorder (spans, time-series) this module is the
*judgment* layer — the piece that turns raw measurements into "is the
fleet meeting its objectives, and if not, how fast is it burning the
error budget?"

Three cooperating parts, all on the fleet's virtual clock:

* :class:`SLIRegistry` — golden-signal service-level indicators (TTFT,
  inter-token latency, queue wait, end-to-end latency, drop / reject /
  retry counts), per **fleet**, per **pool**, and per **SLO class**.
  There is no second instrumentation layer: the registry is fed from
  the same terminal paths that close span chains
  (``Telemetry.record_completion`` / ``record_drop`` /
  ``record_rejection`` — the exact sites that call
  ``Tracer.end_request``), and each signal lands in a
  reservoir-sampled :class:`~repro_torch.router.telemetry.Histogram`.
* :class:`SLOSpec` / :class:`SLOObjective` — the objectives as data
  (JSON round-trip like ``FleetSpec``, unknown-key rejection,
  ``validate()``).  A latency objective like ``p99_ttft_s=0.1`` means
  "99% of requests see their first token within 100 ms"; the error
  budget is the allowed 1%.  ``availability=0.999`` budgets the
  fraction of requests that may be dropped, rejected, or violated.
* :class:`SLOEngine` — multi-window burn-rate evaluation (Google
  SRE-style): each objective keeps a timestamped good/bad event window;
  every tick the engine computes the burn rate (bad fraction over the
  window, divided by the budget) over a **fast** and a **slow** window.
  An alert fires when *both* windows are at or above the severity's
  threshold (``page_burn`` / ``warn_burn``) with at least
  ``min_events`` events in the fast window, and clears with hysteresis
  only when both burns fall below ``clear_frac`` x threshold — so a
  boundary-riding burn cannot flap the alert.

Alerts land on the :class:`AlertBus` that lives on ``Telemetry`` (so
``snapshot()["alerts"]`` always has a stable, zero-initialized shape)
with **stable reason codes** — ``p99_ttft_burn``, ``p99_itl_burn``,
``p99_e2e_burn``, ``availability_burn`` — and the orbit
``FleetController`` consumes them: a firing page alert floors the
dispatch mode at ``"conserve"``, joins the storm-ladder inputs, and any
firing alert suppresses autoscaler scale-down (never retire capacity
while the budget is burning).

Everything here is deterministic for a seeded run: events carry virtual
timestamps, windows are pruned on the virtual clock, and the histograms
use the seeded reservoir.
"""
from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.router.telemetry import Histogram

#: every alert reason code this module can emit (stable contract —
#: dashboards and the orbit controller match on these strings)
REASON_CODES = ("p99_ttft_burn", "p99_itl_burn", "p99_e2e_burn",
                "availability_burn")

#: latency signals an objective may bound (signal -> SLOObjective field)
_LATENCY_SIGNALS = {"p99_ttft": "p99_ttft_s", "p99_itl": "p99_itl_s",
                    "p99_e2e": "p99_e2e_s"}


# ---------------------------------------------------------------------------
# SLI registry: golden signals per fleet / pool / class
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SLIEvent:
    """One terminal-path observation, timestamped on the virtual clock.

    ``kind`` is one of ``"completion"`` / ``"drop"`` / ``"reject"`` /
    ``"retry"``; latency fields are None when the signal does not apply
    (e.g. ITL on a single-token or cost-model request)."""
    t: float
    kind: str
    slo_class: str
    pool: Optional[str] = None
    ttft_s: Optional[float] = None
    itl_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    e2e_s: Optional[float] = None
    violated: bool = False


class SLIScope:
    """Golden signals for one scope (the fleet, one pool, or one class)."""

    __slots__ = ("completed", "dropped", "rejected", "violated", "retries",
                 "ttft_s", "itl_s", "queue_wait_s", "e2e_s")

    def __init__(self):
        self.completed = 0
        self.dropped = 0
        self.rejected = 0
        self.violated = 0
        self.retries = 0
        self.ttft_s = Histogram()
        self.itl_s = Histogram()
        self.queue_wait_s = Histogram()
        self.e2e_s = Histogram()

    def summary(self) -> Dict:
        return {"completed": self.completed, "dropped": self.dropped,
                "rejected": self.rejected, "violated": self.violated,
                "retries": self.retries,
                "ttft_s": self.ttft_s.summary(),
                "itl_s": self.itl_s.summary(),
                "queue_wait_s": self.queue_wait_s.summary(),
                "e2e_s": self.e2e_s.summary()}


class SLIRegistry:
    """Always-on SLI accumulator, one per :class:`Telemetry`.

    Fed from the router/client terminal paths; fans each observation
    into the fleet scope, the request's SLO-class scope, and (when
    known) its pool scope, then notifies listeners (the
    :class:`SLOEngine` subscribes for burn-window events)."""

    def __init__(self):
        self.fleet = SLIScope()
        self.by_class: Dict[str, SLIScope] = {}
        self.by_pool: Dict[str, SLIScope] = {}
        self.listeners: List[Callable[[SLIEvent], None]] = []

    def _scopes(self, slo_class: str, pool: Optional[str]):
        yield self.fleet
        scope = self.by_class.get(slo_class)
        if scope is None:
            scope = self.by_class[slo_class] = SLIScope()
        yield scope
        if pool is not None:
            pscope = self.by_pool.get(pool)
            if pscope is None:
                pscope = self.by_pool[pool] = SLIScope()
            yield pscope

    def _emit(self, ev: SLIEvent) -> None:
        for fn in self.listeners:
            fn(ev)

    def observe_completion(self, t: float, slo_class: str,
                           pool: Optional[str], e2e_s: float,
                           ttft_s: Optional[float] = None,
                           itl_s: Optional[float] = None,
                           queue_wait_s: Optional[float] = None,
                           violated: bool = False) -> None:
        for s in self._scopes(slo_class, pool):
            s.completed += 1
            if violated:
                s.violated += 1
            s.e2e_s.record(e2e_s)
            if ttft_s is not None:
                s.ttft_s.record(ttft_s)
            if itl_s is not None:
                s.itl_s.record(itl_s)
            if queue_wait_s is not None:
                s.queue_wait_s.record(queue_wait_s)
        self._emit(SLIEvent(t, "completion", slo_class, pool, ttft_s,
                            itl_s, queue_wait_s, e2e_s, violated))

    def observe_drop(self, t: float, slo_class: str,
                     pool: Optional[str] = None) -> None:
        for s in self._scopes(slo_class, pool):
            s.dropped += 1
        self._emit(SLIEvent(t, "drop", slo_class, pool))

    def observe_reject(self, t: float, slo_class: str) -> None:
        for s in self._scopes(slo_class, None):
            s.rejected += 1
        self._emit(SLIEvent(t, "reject", slo_class))

    def observe_retry(self, t: float, slo_class: str,
                      pool: Optional[str] = None) -> None:
        for s in self._scopes(slo_class, pool):
            s.retries += 1
        self._emit(SLIEvent(t, "retry", slo_class, pool))

    def summary(self) -> Dict:
        return {"fleet": self.fleet.summary(),
                "by_class": {k: v.summary()
                             for k, v in sorted(self.by_class.items())},
                "by_pool": {k: v.summary()
                            for k, v in sorted(self.by_pool.items())}}


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------
@dataclass
class Alert:
    """One fired alert; ``t_cleared`` is None while it is still firing."""
    reason: str                    # stable code, one of REASON_CODES
    slo_class: str
    severity: str                  # "page" | "warn"
    t_fired: float
    burn_fast: float
    burn_slow: float
    threshold: float               # the burn multiple that fired it
    t_cleared: Optional[float] = None

    @property
    def key(self) -> str:
        return f"{self.reason}:{self.slo_class}:{self.severity}"

    def to_dict(self) -> Dict:
        return {"reason": self.reason, "slo_class": self.slo_class,
                "severity": self.severity,
                "t_fired": round(self.t_fired, 6),
                "burn_fast": round(self.burn_fast, 4),
                "burn_slow": round(self.burn_slow, 4),
                "threshold": self.threshold,
                "t_cleared": (None if self.t_cleared is None
                              else round(self.t_cleared, 6))}


class AlertBus:
    """Fleet alert state, one per :class:`Telemetry`.

    Zero-initialized so ``Telemetry.snapshot()["alerts"]`` has a stable
    shape whether or not an :class:`SLOEngine` is attached or anything
    ever fired.  ``history`` keeps the first ``max_history`` fired
    alerts (cleared ones get their ``t_cleared`` stamped in place)."""

    def __init__(self, max_history: int = 256):
        self.max_history = max_history
        self._firing: Dict[str, Alert] = {}
        self.history: List[Alert] = []
        self.pages_fired = 0               # cumulative, monotone
        self.warns_fired = 0
        self.cleared = 0

    def fire(self, alert: Alert) -> bool:
        """Raise ``alert``; returns False when its key already fires."""
        if alert.key in self._firing:
            return False
        self._firing[alert.key] = alert
        if len(self.history) < self.max_history:
            self.history.append(alert)
        if alert.severity == "page":
            self.pages_fired += 1
        else:
            self.warns_fired += 1
        return True

    def clear(self, key: str, now: float) -> bool:
        alert = self._firing.pop(key, None)
        if alert is None:
            return False
        alert.t_cleared = now
        self.cleared += 1
        return True

    def is_firing(self, key: str) -> bool:
        return key in self._firing

    @property
    def firing(self) -> List[Alert]:
        return list(self._firing.values())

    @property
    def firing_count(self) -> int:
        return len(self._firing)

    @property
    def paging(self) -> bool:
        """Any page-severity alert currently firing (the signal the
        orbit controller floors the mode on)."""
        return any(a.severity == "page" for a in self._firing.values())

    def snapshot(self) -> Dict:
        return {"firing": [a.to_dict() for a in self._firing.values()],
                "firing_count": len(self._firing),
                "pages_fired": self.pages_fired,
                "warns_fired": self.warns_fired,
                "cleared": self.cleared}


# ---------------------------------------------------------------------------
# objectives as data
# ---------------------------------------------------------------------------
@dataclass
class SLOObjective:
    """Per-class objectives.  Latency bounds are p99 targets (99% of
    requests must land at or under the bound); ``availability`` is the
    required fraction of requests not dropped / rejected / violated."""
    slo_class: str
    p99_ttft_s: Optional[float] = None
    p99_itl_s: Optional[float] = None
    p99_e2e_s: Optional[float] = None
    availability: Optional[float] = None

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "SLOObjective":
        valid = set(cls.__dataclass_fields__)
        unknown = sorted(set(d) - valid)
        if unknown:
            raise ValueError(
                f"SLOObjective.from_dict: unknown key(s) {unknown}; "
                f"valid keys are {sorted(valid)}")
        return cls(**d)

    def expanded(self) -> List[Tuple[str, Optional[float], float]]:
        """Concrete (signal, threshold_s, good-fraction target) tuples,
        one per declared bound."""
        out: List[Tuple[str, Optional[float], float]] = []
        for signal, field in _LATENCY_SIGNALS.items():
            bound = getattr(self, field)
            if bound is not None:
                out.append((signal, bound, 0.99))
        if self.availability is not None:
            out.append(("availability", None, self.availability))
        return out


@dataclass
class SLOSpec:
    """The SLO plane as data; ``attach(client)`` makes it live.

    Burn-rate semantics (documented thresholds — the tests pin them):
    an alert of severity *s* (threshold ``page_burn`` or ``warn_burn``)
    **fires** the first tick where both the fast- and slow-window burn
    rates are >= the threshold and the fast window holds at least
    ``min_events`` events; it **clears** only when both burns fall
    below ``clear_frac * threshold`` (hysteresis — no flapping while
    the burn rides the threshold)."""
    objectives: List[SLOObjective]
    fast_window_s: float = 1.0
    slow_window_s: float = 5.0
    page_burn: float = 10.0
    warn_burn: float = 2.0
    clear_frac: float = 0.5
    min_events: int = 5

    # ------------------------------------------------------------------
    # serialization (JSON round-trip, like FleetSpec)
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        return {"objectives": [o.to_dict() for o in self.objectives],
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "page_burn": self.page_burn,
                "warn_burn": self.warn_burn,
                "clear_frac": self.clear_frac,
                "min_events": self.min_events}

    @classmethod
    def from_dict(cls, d: Dict) -> "SLOSpec":
        d = dict(d)
        valid = set(cls.__dataclass_fields__)
        unknown = sorted(set(d) - valid)
        if unknown:
            raise ValueError(
                f"SLOSpec.from_dict: unknown key(s) {unknown}; valid "
                f"keys are {sorted(valid)}")
        d["objectives"] = [SLOObjective.from_dict(o)
                           for o in d.get("objectives", [])]
        return cls(**d)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self) -> "SLOSpec":
        """Fail fast before the engine goes live (called by
        ``attach()``)."""
        if not self.objectives:
            raise ValueError("SLOSpec needs at least one SLOObjective")
        seen = set()
        for o in self.objectives:
            if o.slo_class in seen:
                raise ValueError(f"duplicate objective for SLO class "
                                 f"{o.slo_class!r}")
            seen.add(o.slo_class)
            if not o.expanded():
                raise ValueError(f"objective for {o.slo_class!r} declares "
                                 f"no bound (set p99_*_s or availability)")
            for field in _LATENCY_SIGNALS.values():
                bound = getattr(o, field)
                if bound is not None and bound <= 0:
                    raise ValueError(f"{o.slo_class!r}.{field} must be "
                                     f"> 0 (got {bound})")
            if o.availability is not None \
                    and not 0.0 < o.availability < 1.0:
                raise ValueError(f"{o.slo_class!r}.availability must be "
                                 f"in (0, 1) (got {o.availability}) — "
                                 f"1.0 leaves a zero error budget")
        if not 0.0 < self.fast_window_s < self.slow_window_s:
            raise ValueError(
                f"need 0 < fast_window_s < slow_window_s, got "
                f"{self.fast_window_s} / {self.slow_window_s}")
        if not 0.0 < self.warn_burn <= self.page_burn:
            raise ValueError(f"need 0 < warn_burn <= page_burn, got "
                             f"{self.warn_burn} / {self.page_burn}")
        if not 0.0 < self.clear_frac <= 1.0:
            raise ValueError(f"clear_frac must be in (0, 1] "
                             f"(got {self.clear_frac})")
        if self.min_events < 1:
            raise ValueError(f"min_events must be >= 1 "
                             f"(got {self.min_events})")
        return self

    # ------------------------------------------------------------------
    # assembly
    # ------------------------------------------------------------------
    def attach(self, client) -> "SLOEngine":
        """Build the live engine onto a ServingClient (one per client);
        ``ServingClient.advance`` steps it every tick."""
        self.validate()
        if getattr(client, "slo_engine", None) is not None:
            raise ValueError("an SLO engine is already attached")
        engine = SLOEngine(client, self)
        client.attach_slo(engine)
        return engine


# ---------------------------------------------------------------------------
# burn-rate evaluation
# ---------------------------------------------------------------------------
class _Tracker:
    """Multi-window burn state for one (class, signal) objective."""

    def __init__(self, slo_class: str, signal: str,
                 threshold: Optional[float], target: float, spec: SLOSpec):
        self.slo_class = slo_class
        self.signal = signal              # "p99_ttft" | ... | "availability"
        self.threshold = threshold        # latency bound; None for avail
        self.target = target              # required good-event fraction
        self.budget = max(1.0 - target, 1e-9)
        self.spec = spec
        # two event windows with incremental bad-counts: ``burn()`` runs
        # every fleet tick, so it must amortize O(1) per event, never
        # rescan the windows
        self.events: deque = deque()      # (t, good) within slow window
        self._fast: deque = deque()       # (t, good) within fast window
        self._bad_slow = 0
        self._bad_fast = 0
        self.total = 0                    # cumulative events (monotone)
        self.bad = 0                      # cumulative bad events (monotone)
        self.reason = f"{signal}_burn"

    def _judge(self, ev: SLIEvent) -> Optional[bool]:
        """Good / bad / not-applicable (None) for this objective."""
        if ev.slo_class != self.slo_class:
            return None
        if self.signal == "availability":
            if ev.kind == "completion":
                return not ev.violated
            if ev.kind in ("drop", "reject"):
                return False
            return None
        if ev.kind == "drop":
            # a dropped request never delivered its first token at all:
            # the worst possible latency outcome, so it burns budget
            return False
        if ev.kind != "completion":
            return None
        value = {"p99_ttft": ev.ttft_s, "p99_itl": ev.itl_s,
                 "p99_e2e": ev.e2e_s}[self.signal]
        if value is None:
            return None                   # signal not measurable here
        return value <= self.threshold

    def observe(self, ev: SLIEvent) -> None:
        good = self._judge(ev)
        if good is None:
            return
        self.events.append((ev.t, good))
        self._fast.append((ev.t, good))
        self.total += 1
        if not good:
            self.bad += 1
            self._bad_slow += 1
            self._bad_fast += 1

    def burn(self, now: float) -> Tuple[float, float, int, int]:
        """(burn_fast, burn_slow, n_fast, n_slow) at virtual ``now``:
        bad-event fraction over each window divided by the budget."""
        horizon = now - self.spec.slow_window_s
        ev = self.events
        while ev and ev[0][0] < horizon:
            if not ev.popleft()[1]:
                self._bad_slow -= 1
        t_fast = now - self.spec.fast_window_s
        fv = self._fast
        while fv and fv[0][0] < t_fast:
            if not fv.popleft()[1]:
                self._bad_fast -= 1
        n_slow, n_fast = len(ev), len(fv)
        burn_fast = self._bad_fast / n_fast / self.budget if n_fast else 0.0
        burn_slow = self._bad_slow / n_slow / self.budget if n_slow else 0.0
        return burn_fast, burn_slow, n_fast, n_slow

    def budget_remaining(self) -> float:
        """Fraction of the cumulative error budget left, in [0, 1]:
        the budget allows ``budget x total`` bad events; consumption
        (``bad``) is monotone."""
        if not self.total:
            return 1.0
        return max(0.0, 1.0 - self.bad / (self.budget * self.total))


class SLOEngine:
    """Live burn-rate evaluator over one client's SLI stream.

    Subscribes to the telemetry's :class:`SLIRegistry` (so completions,
    drops, rejections, and retries flow in from the terminal paths with
    no extra instrumentation) and drives the telemetry's
    :class:`AlertBus` from ``step(now)`` — called by
    ``ServingClient.advance`` every tick, *before* the orbit controller
    steps, so control decisions see this tick's alert state."""

    def __init__(self, client, spec: SLOSpec):
        self.client = client
        self.spec = spec
        tel = client.router.telemetry
        self.slis: SLIRegistry = tel.slis
        self.bus: AlertBus = tel.alerts
        self.trackers: List[_Tracker] = []
        for obj in spec.objectives:
            for signal, threshold, target in obj.expanded():
                self.trackers.append(
                    _Tracker(obj.slo_class, signal, threshold, target,
                             spec))
        self.slis.listeners.append(self._observe)
        # step() runs every fleet tick: precompute each tracker's alert
        # keys and thresholds so the hot loop allocates nothing
        self._eval = [
            (tr, (("page", spec.page_burn,
                   f"{tr.reason}:{tr.slo_class}:page"),
                  ("warn", spec.warn_burn,
                   f"{tr.reason}:{tr.slo_class}:warn")))
            for tr in self.trackers]
        # per-tick ring for Chrome-trace counter tracks: (t, worst fast
        # burn, firing alerts, min budget remaining)
        self.history: deque = deque(maxlen=4096)

    def _observe(self, ev: SLIEvent) -> None:
        for tr in self.trackers:
            tr.observe(ev)

    def step(self, now: float) -> None:
        worst_burn = 0.0
        budget_min = 1.0
        for tr, severities in self._eval:
            burn_fast, burn_slow, n_fast, _ = tr.burn(now)
            worst_burn = max(worst_burn, burn_fast)
            budget_min = min(budget_min, tr.budget_remaining())
            for severity, thr, key in severities:
                if self.bus.is_firing(key):
                    clear_at = thr * self.spec.clear_frac
                    if burn_fast < clear_at and burn_slow < clear_at:
                        self.bus.clear(key, now)
                elif (n_fast >= self.spec.min_events
                        and burn_fast >= thr and burn_slow >= thr):
                    self.bus.fire(Alert(tr.reason, tr.slo_class, severity,
                                        now, burn_fast, burn_slow, thr))
        self.history.append((now, worst_burn, self.bus.firing_count,
                             budget_min))

    # ------------------------------------------------------------------
    # read side
    # ------------------------------------------------------------------
    def objectives(self, now: Optional[float] = None) -> List[Dict]:
        """Per-objective evaluation state (burns, budget, alert flags)."""
        now = self.client.now if now is None else now
        out = []
        for tr in self.trackers:
            burn_fast, burn_slow, _, _ = tr.burn(now)
            out.append({
                "slo_class": tr.slo_class,
                "objective": tr.signal,
                "threshold_s": tr.threshold,
                "target": tr.target,
                "events": tr.total,
                "bad_events": tr.bad,
                "budget_remaining": round(tr.budget_remaining(), 6),
                "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "page": self.bus.is_firing(
                    f"{tr.reason}:{tr.slo_class}:page"),
                "warn": self.bus.is_firing(
                    f"{tr.reason}:{tr.slo_class}:warn"),
            })
        return out

    def report(self) -> Dict:
        """The full SLO judgment (what ``SLO_report.json`` serializes)."""
        return {"spec": self.spec.to_dict(),
                "objectives": self.objectives(),
                "slis": self.slis.summary(),
                "alerts": self.bus.snapshot(),
                "alert_history": [a.to_dict() for a in self.bus.history]}
