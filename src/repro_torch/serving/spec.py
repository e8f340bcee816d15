"""Declarative fleet specs: one config path for launchers, examples,
benchmarks, and tests (the port of ``repro.serving.spec``).

A :class:`FleetSpec` describes a serving fleet — pools (cost-model
priced, engine-backed, or the windowed baseline), the cost-model
workload the router's Pareto frontier is scheduled over, SLO classes,
and scheduled faults — as plain data.  ``to_dict`` / ``from_dict``
round-trip losslessly through JSON, so a launcher flag set, a benchmark
scenario, and a test fixture are literally the same object.
``FleetSpec.build()`` assembles the live system (Router + pools +
executors + FailoverController) and returns the one front door:
:class:`~repro_torch.serving.client.ServingClient`.

MPAI's single-submission-interface story in code: the caller writes a
spec and submits prompts; which accelerator profile, pool, or engine
slot serves each request is the router's business.

The port reads the reference's fleet JSON unchanged and serves it through
its own engines, on the device ``build(device=...)`` names (the card by
default).  What the port does not serve yet refuses loudly, before any
weights are touched: the co-processing split (``prefill_backend=
"engine"``), stage-axis pools (``pipeline_stages``) and hardened engine
pools (``harden=True``, which a data-plane :class:`FaultSpec` turns on);
a hardened pool whose stack paged decode cannot serve still falls back to
the windowed loop, as in the reference.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.router.slo import SLOClass

# SLO classes every fleet understands in addition to router.slo's
# mission classes: "offline" is the relaxed default for LM serving.
DEFAULT_SLOS: Dict[str, SLOClass] = {
    "offline": SLOClass("offline", max_latency_s=600.0),
}


def _reject_unknown_keys(cls, d: Dict, label: str) -> None:
    """from_dict guard: a typo'd key must not silently vanish into a
    TypeError traceback deep in dataclass __init__."""
    valid = {f.name for f in cls.__dataclass_fields__.values()}
    unknown = sorted(set(d) - valid)
    if unknown:
        raise ValueError(
            f"{label}.from_dict: unknown key(s) {unknown}; valid keys "
            f"are {sorted(valid)}")


@dataclass
class PoolSpec:
    """One accelerator pool: capability, batching window, and backend.

    ``backend``:
      * ``"costmodel"`` — batches priced by the roofline cost model on
        the router's virtual clock (routing-fabric experiments);
      * ``"engine"`` — a real :class:`ContinuousBatchingEngine` decode
        pool (falls back to the windowed loop, with a warning, for
        stacks paged decode cannot serve);
      * ``"windowed"`` — the legacy windowed baseline, kept for
        engine-vs-windowed benchmark comparisons.

    ``max_prompt_len`` (engine pools) admits prompts beyond the
    ``prompt_len`` bucket via chunked paged prefill — it sizes the KV
    table only, so only block budget bounds it.

    ``prefill_backend="engine"`` disaggregates the pool into MPAI's
    co-processing split: a prefill-class engine (the DPU analogue,
    running ``prefill_plan`` — e.g. ``"mpai"`` for the int8 cost-model
    plan) fills paged KV blocks and hands them to the decode-class
    engine (the VPU analogue) over mirrored pools.  The fleet routes
    one pool; telemetry and the orbit energy bucket see two —
    ``<name>`` (decode) and ``<name>.prefill`` — each charged its own
    stage (``prefill_energy_scale`` scales the plan's per-token energy
    for the cheaper prefill engine).
    """
    name: str
    profiles: Tuple[str, ...]
    backend: str = "costmodel"
    capacity: int = 1
    max_window: int = 4
    max_wait_s: float = 0.02
    # engine/windowed backends only:
    max_slots: int = 4
    prompt_len: int = 16
    max_new: int = 8                     # default per-request budget
    block_size: int = 8
    num_blocks: Optional[int] = None     # None -> slots * ceil(max_len/block)
    plan: Optional[str] = None           # None/"bf16" | "mpai"
    plan_split: Optional[int] = None     # mpai split point override
    max_prompt_len: Optional[int] = None  # None -> prompt_len bucket only
    prefill_chunk: Optional[int] = None   # chunk width; None -> prompt_len
    # prefill/decode disaggregation (engine backend only):
    prefill_backend: Optional[str] = None     # None | "engine"
    prefill_plan: Optional[str] = None        # None/"bf16" | "mpai"
    prefill_energy_scale: float = 0.5         # DPU-vs-VPU per-token energy
    # pod-scale fan-out: N decode-shard engines behind one prefill stage
    # (requires prefill_backend="engine"); every handoff crosses the
    # seam in PrefillHandoff wire form and the least-loaded shard
    # imports it.  1 == the classic unsharded co-processing split.
    decode_shards: int = 1
    # stage-axis execution: span this pool's decode across a device
    # group via core.pipeline.pipeline_apply (engine backend only;
    # mutually exclusive with disaggregation — a staged pool is one
    # consumer).  None -> single-device engine.
    pipeline_stages: Optional[int] = None
    # radiation hardening (engine backends): per-block KV integrity
    # digests + fused decode-path verification + no-progress watchdog.
    # Off by default — hardened output with no faults is bit-identical
    # to hardening-off, but the checksum adds a small decode cost.
    # ``build()`` flips it on automatically for pools targeted by a
    # data-plane FaultSpec (kind != "pool").
    harden: bool = False
    scrub_blocks: int = 2                # background scrub budget / tick
    watchdog_steps: int = 8              # decode steps before a stalled
                                         # slot is evicted and replayed

    def __post_init__(self):
        if self.backend not in ("costmodel", "engine", "windowed"):
            raise ValueError(f"unknown pool backend {self.backend!r}")
        if self.prefill_backend not in (None, "engine"):
            raise ValueError(
                f"unknown prefill backend {self.prefill_backend!r}")
        if self.prefill_backend is not None and self.backend != "engine":
            raise ValueError(
                f"pool {self.name!r}: prefill_backend requires "
                f"backend='engine' (got {self.backend!r})")
        self.profiles = tuple(self.profiles)

    def validate(self) -> "PoolSpec":
        """Fail fast on values ``build()`` would only trip over deep in
        engine assembly (or worse, serve wrong).  Raises ``ValueError``
        with the pool name and the offending field; returns self so
        call sites can chain."""
        def bad(msg: str) -> ValueError:
            return ValueError(f"pool {self.name!r}: {msg}")
        if not self.name:
            raise ValueError("pool name must be non-empty")
        if not self.profiles:
            raise bad("profiles must be non-empty — the router can "
                      "never route to a pool that serves nothing")
        if self.capacity < 1:
            raise bad(f"capacity must be >= 1 (got {self.capacity})")
        if self.max_window < 1:
            raise bad(f"max_window must be >= 1 (got {self.max_window})")
        if self.max_wait_s < 0:
            raise bad(f"max_wait_s must be >= 0 (got {self.max_wait_s})")
        if self.max_slots < 1:
            raise bad(f"max_slots must be >= 1 (got {self.max_slots})")
        if self.prompt_len < 1:
            raise bad(f"prompt_len must be >= 1 (got {self.prompt_len})")
        if self.max_new < 1:
            raise bad(f"max_new must be >= 1 (got {self.max_new})")
        if self.block_size < 1:
            raise bad(f"block_size must be >= 1 (got {self.block_size})")
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise bad(f"prefill_chunk must be positive "
                          f"(got {self.prefill_chunk})")
            if self.prefill_chunk % self.block_size != 0:
                raise bad(
                    f"prefill_chunk={self.prefill_chunk} must be a "
                    f"multiple of block_size={self.block_size} — chunked "
                    f"prefill writes whole KV blocks")
        if self.num_blocks is not None and self.num_blocks < 1:
            raise bad(f"num_blocks must be >= 1 (got {self.num_blocks})")
        if self.max_prompt_len is not None and self.max_prompt_len < 1:
            raise bad(f"max_prompt_len must be >= 1 "
                      f"(got {self.max_prompt_len})")
        if self.prefill_energy_scale < 0:
            raise bad(f"prefill_energy_scale must be >= 0 "
                      f"(got {self.prefill_energy_scale})")
        if self.decode_shards < 1:
            raise bad(f"decode_shards must be >= 1 "
                      f"(got {self.decode_shards})")
        if self.decode_shards > 1 and self.prefill_backend != "engine":
            raise bad(
                f"decode_shards={self.decode_shards} requires "
                f"prefill_backend='engine' — sharded decode is the "
                f"fan-out side of the co-processing split")
        if self.pipeline_stages is not None:
            if self.pipeline_stages < 2:
                raise bad(f"pipeline_stages must be >= 2 when set "
                          f"(got {self.pipeline_stages})")
            if self.backend != "engine":
                raise bad("pipeline_stages requires backend='engine'")
            if self.prefill_backend is not None or self.decode_shards > 1:
                raise bad(
                    "pipeline_stages is mutually exclusive with "
                    "prefill_backend/decode_shards — a staged pool is "
                    "one consumer spanning a device group")
            if self.max_prompt_len is not None:
                raise bad("pipeline_stages does not support "
                          "max_prompt_len (chunked prefill) yet")
        if self.scrub_blocks < 0:
            raise bad(f"scrub_blocks must be >= 0 (got "
                      f"{self.scrub_blocks}); 0 disables background scrub")
        if self.watchdog_steps < 1:
            raise bad(f"watchdog_steps must be >= 1 "
                      f"(got {self.watchdog_steps})")
        return self

    @property
    def chunk(self) -> int:
        """The prefill chunk grid (block-aligned; prompts pad to it)."""
        if self.prefill_chunk is not None:
            return self.prefill_chunk
        return max(self.block_size,
                   self.prompt_len // self.block_size * self.block_size)

    @property
    def max_len(self) -> int:
        # +2 floor keeps one decode step available for the warm-up
        # requests even for max_new=1 pools.  max_prompt_len is a
        # guarantee, not a cap: it rounds UP to the chunk grid, so every
        # prompt up to it (and its grid remainder) actually fits the KV
        # table
        prompt = self.prompt_len
        if self.max_prompt_len is not None and self.max_prompt_len > prompt:
            prompt = -(-self.max_prompt_len // self.chunk) * self.chunk
        return prompt + max(self.max_new, 2)

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["profiles"] = list(self.profiles)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "PoolSpec":
        _reject_unknown_keys(cls, d, "PoolSpec")
        return cls(**{**d, "profiles": tuple(d["profiles"])})


@dataclass
class FaultSpec:
    """A scheduled upset (SEU) on the fleet's clock.

    ``kind`` picks the blast radius (see
    :class:`~repro_torch.runtime.fault.PoolFault`): ``"pool"`` (default) is
    the control-plane fault — the pool loses profiles and in-flight
    work fails over; ``"kv_bitflip"`` / ``"slot_stall"`` /
    ``"handoff_loss"`` are data-plane faults delivered inside the
    pool's engine (``seed`` picks the bitflip site, ``slot`` the
    stalled slot) and require a hardened engine pool to be detected —
    ``build()`` hardens the target pool automatically.
    """
    pool: str
    at_s: float
    duration_s: float = math.inf
    lost_profiles: Tuple[str, ...] = ()
    kind: str = "pool"
    slot: int = 0                        # slot_stall target
    seed: int = 0                        # kv_bitflip site selector

    _KINDS = ("pool", "kv_bitflip", "slot_stall", "handoff_loss")

    def __post_init__(self):
        self.lost_profiles = tuple(self.lost_profiles)
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {self._KINDS})")

    def to_dict(self) -> Dict:
        d = asdict(self)
        d["lost_profiles"] = list(self.lost_profiles)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultSpec":
        _reject_unknown_keys(cls, d, "FaultSpec")
        return cls(**{**d, "lost_profiles": tuple(d.get("lost_profiles",
                                                        ()))})


@dataclass
class FleetSpec:
    """The whole fleet as data.  ``build()`` returns a ServingClient."""
    pools: List[PoolSpec]
    workload: str = "ursonet"            # "ursonet" | "transformer"
    arch: Optional[str] = None           # config-registry name (LM fleets)
    smoke: bool = True                   # reduced config for the arch
    seq_len: int = 512                   # cost-model pricing length
    accuracy_penalty: Dict[str, float] = field(default_factory=dict)
    cut_candidates: Optional[List[int]] = None
    slos: List[Dict] = field(default_factory=list)   # extra SLOClass kwargs
    faults: List[FaultSpec] = field(default_factory=list)
    dt: float = 0.002                    # clock tick for drive loops
    latency_headroom: float = 0.6
    trace: bool = False                  # flight recorder on from tick 0
    # bounded redispatch: RetryPolicy kwargs per SLO class name; the
    # "default" key replaces the router's fleet-wide default policy
    retry: Dict[str, Dict] = field(default_factory=dict)
    # client-side no-progress watchdog window (virtual seconds a
    # streaming request may go without a new token); None -> disabled
    watchdog_s: Optional[float] = None
    # SLO plane (repro_torch.obs.slo.SLOSpec): objectives + burn-rate alert
    # windows; build() attaches the live engine.  None -> SLIs only.
    slo: Optional[object] = None

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "pools": [p.to_dict() for p in self.pools],
            "workload": self.workload,
            "arch": self.arch,
            "smoke": self.smoke,
            "seq_len": self.seq_len,
            "accuracy_penalty": dict(self.accuracy_penalty),
            "cut_candidates": (None if self.cut_candidates is None
                               else list(self.cut_candidates)),
            "slos": [dict(s) for s in self.slos],
            "faults": [f.to_dict() for f in self.faults],
            "dt": self.dt,
            "latency_headroom": self.latency_headroom,
            "trace": self.trace,
            "retry": {k: dict(v) for k, v in self.retry.items()},
            "watchdog_s": self.watchdog_s,
            "slo": None if self.slo is None else self.slo.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "FleetSpec":
        d = dict(d)
        _reject_unknown_keys(cls, d, "FleetSpec")
        d["pools"] = [PoolSpec.from_dict(p) for p in d["pools"]]
        d["faults"] = [FaultSpec.from_dict(f) for f in d.get("faults", [])]
        if d.get("slo") is not None:
            from repro_torch.obs.slo import SLOSpec
            d["slo"] = SLOSpec.from_dict(d["slo"])
        return cls(**d)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self) -> "FleetSpec":
        """Fail fast before any engine is built.  Checks every pool,
        fleet-level clock/retry settings, and cross-references (fault
        targets, duplicate pool names).  Called by ``build()``."""
        if not self.pools:
            raise ValueError("FleetSpec needs at least one pool")
        names = [p.name for p in self.pools]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate pool name(s) {dupes} — telemetry "
                             f"and routing key pools by name")
        for p in self.pools:
            p.validate()
        if self.dt <= 0:
            raise ValueError(f"dt must be > 0 (got {self.dt})")
        if self.latency_headroom <= 0:
            raise ValueError(f"latency_headroom must be > 0 "
                             f"(got {self.latency_headroom})")
        if self.watchdog_s is not None and self.watchdog_s <= 0:
            raise ValueError(f"watchdog_s must be > 0 when set "
                             f"(got {self.watchdog_s})")
        from repro_torch.router.dispatch import RetryPolicy
        retry_fields = {f.name for f in
                        RetryPolicy.__dataclass_fields__.values()}
        for slo_name, kw in self.retry.items():
            unknown = sorted(set(kw) - retry_fields)
            if unknown:
                raise ValueError(
                    f"retry[{slo_name!r}]: unknown RetryPolicy key(s) "
                    f"{unknown}; valid keys are {sorted(retry_fields)}")
            if kw.get("max_attempts", 1) < 1:
                raise ValueError(
                    f"retry[{slo_name!r}]: max_attempts must be >= 1 "
                    f"(got {kw['max_attempts']})")
            for k in ("backoff_s", "multiplier", "max_backoff_s"):
                if k in kw and kw[k] <= 0:
                    raise ValueError(
                        f"retry[{slo_name!r}]: {k} must be > 0 "
                        f"(got {kw[k]})")
        pool_names = set(names)
        for f in self.faults:
            if f.pool not in pool_names:
                raise ValueError(
                    f"fault targets unknown pool {f.pool!r}; fleet pools "
                    f"are {sorted(pool_names)}")
            if f.duration_s <= 0:
                raise ValueError(
                    f"fault on {f.pool!r}: duration_s must be > 0 "
                    f"(got {f.duration_s})")
        if self.slo is not None:
            self.slo.validate()
        return self

    # ------------------------------------------------------------------
    # assembly
    # ------------------------------------------------------------------
    def slo_classes(self) -> Dict[str, SLOClass]:
        out = dict(DEFAULT_SLOS)
        for kw in self.slos:
            slo = SLOClass(**kw)
            out[slo.name] = slo
        return out

    def _layer_costs(self, cfg=None):
        if self.workload == "ursonet":
            from repro_torch.core.cost_model import layer_costs_from_convspecs
            from repro_torch.models.cnn import ursonet_table1_layers
            return layer_costs_from_convspecs(ursonet_table1_layers())
        if self.workload == "transformer":
            from repro_torch.core.cost_model import transformer_layer_costs
            if cfg is None:
                cfg = self._config()
            return transformer_layer_costs(cfg, seq_len=self.seq_len)
        raise ValueError(f"unknown workload {self.workload!r}")

    def _config(self):
        if self.arch is None:
            raise ValueError("transformer workload needs arch= (or pass "
                             "model=(cfg, params) to build())")
        from repro_torch.configs import get_config
        return get_config(self.arch, smoke=self.smoke)

    def build(self, model=None, warm: bool = True, device="cuda"):
        """Assemble the live fleet; returns a ServingClient.

        ``model`` — optional ``(cfg, params)`` shared by every engine/
        windowed pool (tests and benchmarks pass tiny hand-built
        configs, and parity tests the reference's weights through
        ``repro_torch.bridge``); otherwise the arch registry and the
        port's own seed-0 init (``T.model_init`` with a seed-0
        ``torch.Generator`` on ``device``) provide it.  Those are not the
        reference's weights: its ``PRNGKey(0)`` stream has no torch
        twin.  ``warm`` runs throwaway requests through each LM server
        so first-use costs (kernel builds, allocator growth) never land
        in the first routed batch's latency telemetry.  Every LM server
        runs on ``device``.
        """
        import torch

        from repro_torch.router import FailoverController, Router
        from repro_torch.runtime.fault import PoolFault, PoolFaultInjector
        from repro_torch.serving.client import ServingClient

        self.validate()
        # data-plane faults act inside an engine; detection needs the
        # hardening layer, so harden any targeted pool (a local replace
        # — the spec the caller holds is untouched)
        hardened_targets = {f.pool for f in self.faults if f.kind != "pool"}
        specs = [replace(ps, harden=True)
                 if ps.name in hardened_targets and not ps.harden else ps
                 for ps in self.pools]
        cfg = params = None
        if any(p.backend != "costmodel" for p in specs):
            cfg = model[0] if model is not None else self._config()
            for ps in specs:
                _refuse_unported(ps, cfg)
            if model is not None:
                params = model[1]
            else:
                from repro_torch.models import transformer as T
                params = T.model_init(
                    cfg, torch.Generator(device).manual_seed(0),
                    device=device)
        layers = self._layer_costs(cfg)
        model = None if cfg is None else (cfg, params)

        pools, engines, executors = [], {}, []
        for ps in specs:
            pool, engine, ex = build_pool(ps, layers, model=model, warm=warm,
                                          device=device)
            pools.append(pool)
            if engine is not None:
                engines[ps.name] = engine
                executors.append(ex)

        router = Router(layers, pools,
                        accuracy_penalty=self.accuracy_penalty or None,
                        cut_candidates=self.cut_candidates,
                        latency_headroom=self.latency_headroom)
        for ex in executors:
            if getattr(ex, "prefill_counters", None) is not None:
                # bind back: a reused stage name continues its history
                ex.prefill_counters = router.register_stage_pool(
                    ex.prefill_pool, ex.prefill_counters)
        if self.retry:
            from repro_torch.router.dispatch import RetryPolicy
            for slo_name, kw in self.retry.items():
                policy = RetryPolicy(**kw)
                if slo_name == "default":
                    router.default_retry = policy
                else:
                    router.retry_policies[slo_name] = policy
        injector = PoolFaultInjector([
            PoolFault(f.pool, at_s=f.at_s, duration_s=f.duration_s,
                      lost_profiles=f.lost_profiles, kind=f.kind,
                      slot=f.slot, seed=f.seed) for f in self.faults])
        failover = FailoverController(router, injector)
        client = ServingClient(router, failover, engines=engines, spec=self,
                               dt=self.dt, slo_map=self.slo_classes(),
                               model=model, layers=layers,
                               watchdog_s=self.watchdog_s, device=device)
        for ex in executors:
            ex.on_token = client._on_token
        if self.trace:
            # after warmup: the throwaway warm-up requests never appear
            # in the flight recorder
            client.enable_tracing()
        if self.slo is not None:
            self.slo.attach(client)
        return client


def build_pool(ps: PoolSpec, layers, model=None, warm: bool = True,
               device="cuda"):
    """Assemble one live pool from its spec.

    Returns ``(pool, engine, executor)``; ``engine``/``executor`` are
    None for cost-model pools.  ``FleetSpec.build()`` and live fleet
    growth (:meth:`~repro_torch.serving.client.ServingClient.add_pool`, the
    orbit autoscaler's seam) share this single construction path, so a
    pool added mid-flight is indistinguishable from one built at spec
    time.  ``model`` is the ``(cfg, params)`` pair engine/windowed
    backends decode with, on ``device``.
    """
    from repro_torch.router import AcceleratorPool, CostModelExecutor
    from repro_torch.router.telemetry import PoolCounters
    from repro_torch.serving.executor import EngineExecutor

    ps.validate()          # live fleet growth skips FleetSpec.validate()
    engine = engine_ex = None
    if ps.backend == "costmodel":
        ex = CostModelExecutor(layers)
    else:
        if model is None:
            raise ValueError(
                f"pool {ps.name!r} needs a model: the fleet was built "
                f"without one (no LM pools at build time); pass model= "
                f"or include an engine pool in the original FleetSpec")
        cfg, params = model
        engine = make_server(cfg, params, ps, warm=warm, device=device)
        kw = {}
        if ps.prefill_backend is not None:
            # disaggregated pool: the prefill stage gets its own named
            # counters so dispatch/energy telemetry charges each stage
            # to its own pool (registered with the router by the caller)
            kw = dict(prefill_pool=f"{ps.name}.prefill",
                      prefill_counters=PoolCounters(),
                      prefill_energy_scale=ps.prefill_energy_scale)
        ex = engine_ex = EngineExecutor(engine, max_new=ps.max_new, **kw)
    pool = AcceleratorPool(ps.name, ps.profiles, ex,
                           capacity=ps.capacity,
                           max_window=ps.max_window,
                           max_wait_s=ps.max_wait_s,
                           shards=ps.decode_shards)
    if engine_ex is not None:
        engine_ex.counters = pool.counters
    return pool, engine, engine_ex


def make_server(cfg, params, spec: PoolSpec, warm: bool = True,
                device="cuda"):
    """Construct the LM server a PoolSpec describes, on ``device``.

    The facade-sanctioned constructor for decode servers —
    ``spec.build()`` comes through here, so no call site outside
    ``repro_torch.serving`` touches the engine classes directly.
    ``backend="engine"`` falls back to the windowed loop (with a warning)
    for stacks paged decode cannot serve.  The co-processing split,
    stage-axis pools and hardened engine pools are not ported yet and
    raise ``NotImplementedError`` before any server is built.
    """
    import numpy as np

    from repro_torch.runtime.serve import (ContinuousBatchingEngine, Request,
                                           WindowedBaselineServer,
                                           engine_or_windowed)
    _refuse_unported(spec, cfg)
    plan = _resolve_plan(spec, cfg, spec.plan)
    hkw = dict(harden=spec.harden, watchdog_steps=spec.watchdog_steps,
               scrub_blocks=spec.scrub_blocks)
    if spec.backend == "engine":
        srv = engine_or_windowed(
            params, cfg, plan=plan, max_slots=spec.max_slots,
            prompt_len=spec.prompt_len, max_len=spec.max_len,
            block_size=spec.block_size, num_blocks=spec.num_blocks,
            prefill_chunk=spec.prefill_chunk, **hkw,
            on_fallback=lambda e: warnings.warn(
                f"pool {spec.name!r}: paged decode unavailable ({e}); "
                f"falling back to the windowed baseline"), device=device)
    else:
        srv = WindowedBaselineServer(params, cfg, plan=plan,
                                     max_batch=spec.max_slots,
                                     prompt_len=spec.prompt_len,
                                     max_len=spec.max_len, device=device)
    if warm:
        # throwaway requests take every serving path's first-use costs
        # before traffic (bucket prefill and decode, and on over-bucket
        # engine pools chunked prefill), so no routed batch pays them
        # into the latency telemetry.  The reference's second warm-up
        # request is sampled; the port decodes greedily, so it runs the
        # same prompt and budget greedily and the allocator's books after
        # warm-up match the reference's.
        srv.submit(Request(-1, np.array([1, 2], np.int32), max_new=2))
        srv.flush()
        if isinstance(srv, ContinuousBatchingEngine):
            srv.submit(Request(-2, np.array([1, 2], np.int32), max_new=2))
            srv.flush()
        if (isinstance(srv, ContinuousBatchingEngine)
                and spec.max_prompt_len is not None
                and spec.max_prompt_len > spec.prompt_len
                and srv.padded_prompt_len(spec.prompt_len + 1) + 2
                <= srv.max_len):
            # over-bucket pool: run the chunked-prefill path too
            srv.submit(Request(-3, np.arange(
                1, spec.prompt_len + 2, dtype=np.int32), max_new=2))
            srv.flush()
        srv.reset_stats()
    return srv


def _refuse_unported(spec: PoolSpec, cfg) -> None:
    """Raise ``NotImplementedError`` for a pool the port cannot serve yet
    (each names its item in ROADMAP.md's port queue), before any weights
    or servers are touched.  A hardened engine pool whose stack paged
    decode cannot serve is not refused: it falls back to the windowed
    loop, which takes no hardening, as in the reference."""
    if spec.backend == "costmodel":
        return
    if spec.prefill_backend == "engine":
        raise NotImplementedError(
            f"pool {spec.name!r}: the co-processing split "
            f"(prefill_backend='engine', CoProcServer) is not ported yet "
            f"(ROADMAP.md, port queue item 4)")
    if spec.pipeline_stages is not None:
        raise NotImplementedError(
            f"pool {spec.name!r}: stage-axis pools (pipeline_stages, "
            f"StageAxisEngine) are not ported yet (ROADMAP.md, port queue "
            f"item 12)")
    if spec.harden and spec.backend == "engine" and _pageable(cfg):
        raise NotImplementedError(
            f"pool {spec.name!r}: hardened engine pools (harden=True, or "
            f"the target of a data-plane FaultSpec) are not ported yet "
            f"(ROADMAP.md, port queue item 3)")


def _pageable(cfg) -> bool:
    """Can paged decode serve ``cfg``?  Asks the paged-cache constructor
    on the meta device, which allocates nothing."""
    from repro_torch.models import transformer as T
    try:
        T.init_paged_decode_cache(cfg, 1, 1, 1, device="meta")
    except ValueError:
        return False
    return True


def _resolve_plan(spec: PoolSpec, cfg, name: Optional[str]):
    if name in (None, "bf16"):
        return None
    if name == "mpai":
        from repro_torch.core import qat
        from repro_torch.core.partition import PartitionPlan
        kw = {} if spec.plan_split is None else {"split": spec.plan_split}
        return qat.serve_plan(PartitionPlan.mpai(cfg.num_layers, **kw))
    raise ValueError(f"unknown pool plan {name!r}")
