"""Open-loop traffic generation against a ServingClient (the port of
``repro.serving.traffic``).

The Poisson open loop every surface shares.  Arrival times, class draws,
and payload draws consume the seeded numpy RNG in the reference's order,
so a seed gives the same arrival trace in both packages.
"""
from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.client import ResponseHandle, ServingClient


class TrafficTrace(List[ResponseHandle]):
    """``open_loop``'s return value: a plain list of handles (fully
    backward compatible) plus truncation markers.  A run that hits the
    ``max_s`` safety net used to return normally with arrivals never
    submitted and handles incomplete — benchmark traces silently
    shrank; now ``truncated`` flags it (and a warning fires), and
    ``unsubmitted``/``incomplete`` say what was lost, so ``--check``
    gates can fail loudly instead of gating on a partial trace."""
    truncated: bool = False
    unsubmitted: int = 0                 # arrivals never submitted
    incomplete: int = 0                  # submitted but unfinished handles


def poisson_arrivals(classes: Sequence, weights: Sequence[float],
                     rate_hz: float, n_requests: int, seed: int = 0,
                     payload_fn: Optional[Callable] = None
                     ) -> List[Tuple[float, object, object]]:
    """Draw an open-loop arrival trace: [(arrival_s, slo, payload)]."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate_hz)
        slo = classes[rng.choice(len(classes), p=weights)]
        out.append((t, slo, payload_fn(rng) if payload_fn else None))
    return out


def open_loop(client: ServingClient, classes: Sequence,
              weights: Sequence[float], rate_hz: float, n_requests: int,
              seed: int = 0, dt: Optional[float] = None,
              payload_fn: Optional[Callable] = None,
              max_s: float = 600.0) -> TrafficTrace:
    """Drive Poisson open-loop traffic through the fleet until drained.

    ``payload_fn(rng)`` (optional) draws each request's payload: a token
    prompt array or a prebuilt :class:`~repro_torch.serving.executor.LMWork`
    for LM pools; None routes cost-model requests.  Returns every
    request's handle (rejected submissions included — check
    ``handle.admitted``) as a :class:`TrafficTrace`; a run cut short by
    the ``max_s`` safety net is marked ``truncated`` and warns, so
    benchmark gates never silently score a shrunken trace.
    """
    arrivals = poisson_arrivals(classes, weights, rate_hz, n_requests,
                                seed=seed, payload_fn=payload_fn)
    handles = TrafficTrace()
    i = 0
    while i < len(arrivals) or client.outstanding or client.pending_faults:
        client.advance(dt)
        while i < len(arrivals) and arrivals[i][0] <= client.now:
            at, slo, payload = arrivals[i]
            handles.append(client.submit(payload, slo=slo, arrival=at))
            i += 1
        client.pump()
        if client.now > max_s:          # safety net: never loop forever
            handles.truncated = True
            handles.unsubmitted = len(arrivals) - i
            handles.incomplete = sum(1 for h in handles if not h.done)
            warnings.warn(
                f"open_loop truncated at the max_s={max_s}s safety net: "
                f"{handles.unsubmitted} arrivals never submitted, "
                f"{handles.incomplete} in-flight requests incomplete — "
                f"metrics over this trace undercount the offered load",
                RuntimeWarning, stacklevel=2)
            break
    return handles
