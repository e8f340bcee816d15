"""Fault-tolerant training and scheduled serving faults (the port of
``repro.runtime.fault``).

The training contract: any step may raise (device loss, preemption).
``FaultTolerantRunner`` restores the last committed checkpoint,
optionally rebuilds the trainer (``rebuild``: elastic restart, say a
``Trainer`` on ``elastic.surviving_mesh(...)`` over the surviving ranks),
restores into the trainer's mesh, and replays — the deterministic data
pipeline and the deterministic step (no atomics on the card) make the
replayed steps bit-identical on the same mesh.  ``FaultInjector`` raises at
scheduled steps to prove that recovery reproduces the uninterrupted run.

Serving-side faults (router subsystem): onboard accelerators in space see
SEU-style transient upsets — a device drops out, then (usually) comes back
after a scrub/reset.  ``PoolFault`` / ``PoolFaultInjector`` model this at
pool granularity on the router's clock: at ``at_s`` the named pool loses
``lost_profiles`` (or all of them), and recovers after ``duration_s``
unless the fault is permanent (``duration_s=inf``).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.runtime.train_loop import Trainer, TrainState


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


class FaultTolerantRunner:
    def __init__(self, trainer: Trainer, ckpt: CheckpointManager,
                 max_restarts: int = 3,
                 rebuild: Optional[Callable[[], Trainer]] = None):
        self.trainer = trainer
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        self.rebuild = rebuild
        self.restarts = 0

    def _restore(self) -> TrainState:
        if self.rebuild is not None:            # elastic path: new trainer
            self.trainer = self.rebuild()
        state, _ = self.ckpt.restore(
            self.trainer.state_like(), device=self.trainer.device,
            shardings=self.trainer.state_shardings)
        return state

    def run(self, state: TrainState, data_fn, num_steps: int,
            on_step=None, log_every: int = 10):
        target = int(state.step) + num_steps
        # Per-step metric records, keyed by step so a restarted segment's
        # replay overwrites (bit-identically, by determinism) instead of
        # duplicating; a mid-segment fault loses none of the steps that
        # segment logged before it.
        records: dict = {}

        def _observe(s, st, metrics):
            records[s + 1] = {"step": s + 1,
                              "loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"])}
            if on_step is not None:
                on_step(s, st, metrics)

        # always have a step-0 baseline to restart from.  A save on a mesh
        # is collective, so every rank reads the directory before any rank
        # may write to it, and all take the same branch
        fresh = self.ckpt.latest_step() is None
        if self.trainer.state_shardings is not None:
            self.trainer.state_shardings.barrier()
        if fresh:
            self.ckpt.save(int(state.step), state, blocking=True,
                           shardings=self.trainer.state_shardings)
        while int(state.step) < target:
            # hand the state over without keeping it: the trainer frees
            # each step's old state as it goes (the reference donates its
            # buffers), and a 1.6 B-parameter state with AdamW's moments is
            # 19.7 GB
            todo, handed = target - int(state.step), [state]
            del state
            try:
                state, _ = self.trainer.run(
                    handed.pop(), data_fn, todo,
                    ckpt=self.ckpt, on_step=_observe, log_every=log_every)
            except Exception as e:              # noqa: BLE001 — any step fault
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                state = self._restore()
        return state, [records[k] for k in sorted(records)]
