"""The port's serving facade against ``repro.serving`` on cost-model fleets,
where no model runs and every number is plain Python on the virtual clock:
the route demo's vision fleet under its two faults, with the SLO engine
attached and tracing on, gives per-request handles, the telemetry
snapshot, the time-series summary and every span tree identical to the
reference's, and so do the route demo's LM cost-model fleet, live fleet
growth and retirement, bounded retries with drops and the client
watchdog, and an open loop cut by its safety net; fleet specs written by
the reference load into the port and
give back the same dict; the scheduler's frontier and its failover
rescheduling are the reference's on seeded random layer tables; and the
cost model prices the UrsoNet and transformer tables alike.

Both packages run in this process: the control plane has no framework
code, so nothing in it can part the two but the port's copy itself."""
import json
import math

import numpy as np
import pytest

from repro.core import scheduler as jsched
from repro.core.cost_model import LayerCost as JLayerCost
from repro.core.cost_model import layer_costs_from_convspecs as jlayers
from repro.core.cost_model import transformer_layer_costs as jtlayers
from repro.models.cnn import ursonet_table1_layers as jurso
from repro.obs.slo import SLOObjective as JObjective
from repro.obs.slo import SLOSpec as JSLOSpec
from repro.router import SLO_CLASSES as JCLASSES
from repro.serving import FaultSpec as JFault
from repro.serving import FleetSpec as JFleet
from repro.serving import PoolSpec as JPool
from repro.serving import open_loop as jopen_loop

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import scheduler as tsched
from repro_torch.core.accelerators import PROFILES
from repro_torch.core.cost_model import LayerCost as TLayerCost
from repro_torch.core.cost_model import layer_costs_from_convspecs as tlayers
from repro_torch.core.cost_model import transformer_layer_costs as ttlayers
from repro_torch.models.cnn import ursonet_table1_layers as turso
from repro_torch.router import SLO_CLASSES as TCLASSES
from repro_torch.serving import FleetSpec as TFleet
from repro_torch.serving import open_loop as topen_loop

CLASS_NAMES = ("downlink-critical", "realtime-tracking",
               "background-science", "bulk-reprocess")


def vision_spec(Fleet, Pool, Fault, fault_at=3.0, fault_duration=4.0,
                slo=None):
    """``repro.launch.route``'s vision fleet and its two faults: board-b
    drops out whole, half a scrub later the sidecar loses its Edge TPU."""
    return Fleet(
        pools=[Pool("board-a", ("mpsoc_dpu", "myriadx_vpu"), capacity=2,
                    max_window=4),
               Pool("board-b", ("mpsoc_dpu", "myriadx_vpu"), capacity=2,
                    max_window=4),
               Pool("sidecar", ("edge_tpu", "cortex_a53"), capacity=1,
                    max_window=2)],
        workload="ursonet", accuracy_penalty={"mpsoc_dpu": 0.05},
        faults=[Fault("board-b", at_s=fault_at, duration_s=fault_duration),
                Fault("sidecar", at_s=fault_at + fault_duration / 2,
                      lost_profiles=("edge_tpu",),
                      duration_s=fault_duration)],
        trace=True, slo=slo)


def reference_slo():
    return JSLOSpec(objectives=[
        JObjective("downlink-critical", p99_ttft_s=0.05),
        JObjective("realtime-tracking", availability=0.99),
        JObjective("background-science", p99_e2e_s=3.0)],
        fast_window_s=1.0, slow_window_s=4.0, min_events=4)


def _run(spec, Fleet, classes, open_loop, seed, rate):
    """Build the fleet from the reference spec's JSON and drive the seeded
    open loop to the end; returns everything the comparison reads."""
    client = Fleet.from_dict(json.loads(json.dumps(spec.to_dict()))).build()
    handles = open_loop(client, [classes[n] for n in CLASS_NAMES],
                        [0.2, 0.3, 0.3, 0.2], rate_hz=rate, n_requests=300,
                        seed=seed)
    return {
        "truncated": handles.truncated,
        "handles": [h.telemetry for h in handles],
        "results": [(r.rid, r.admitted, r.latency_s, r.violated, r.dropped,
                     r.pool) for r in (h.result() for h in handles)],
        "snapshot": client.telemetry,
        "timeseries": client.timeseries.summary(),
        "series": client.timeseries.to_dict(),
        "traces": [h.trace() for h in handles],
        "tracer": client.tracer.summary(),
        "open_spans": len(client.tracer.open_spans()),
        "frontier": [(p.assignments, p.latency_s, p.energy_j,
                      p.accuracy_penalty) for p in client.router.frontier],
        "frontier_trace": list(client.failover.frontier_sizes),
        "events": [(e.kind, e.fault.pool, e.at_s)
                   for e in client.failover.events],
    }


@pytest.mark.parametrize("seed,rate,with_slo", [(0, 40.0, True),
                                                (3, 40.0, False),
                                                (11, 120.0, True)])
def test_vision_fleet_under_faults_equals_the_reference(seed, rate,
                                                        with_slo):
    spec = vision_spec(JFleet, JPool, JFault,
                       slo=reference_slo() if with_slo else None)
    want = _run(spec, JFleet, JCLASSES, jopen_loop, seed, rate)
    got = _run(spec, TFleet, TCLASSES, topen_loop, seed, rate)
    # the run exercises what it claims to: faults applied, failover, a
    # frontier that shrank while the Edge TPU was out, rejections and
    # violations under load, no orphan span
    snap = want["snapshot"]
    assert not want["truncated"]
    assert snap["failovers"] == 2 and len(want["events"]) == 4
    assert len({n for _, n in want["frontier_trace"]}) > 1
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    assert snap["violations"] > 0 and want["open_spans"] == 0
    assert want["tracer"]["spans"] > 300
    for key in want:
        assert got[key] == want[key], key


def _lm_costmodel(pk):
    """``repro.launch.route``'s LM section: TPU v5e operating points over
    the qwen3-14b smoke table, custom classes, a transient pool fault."""
    Fleet, Pool, Fault = pk["FleetSpec"], pk["PoolSpec"], pk["FaultSpec"]
    spec = Fleet(
        pools=[Pool("pod-int8", ("tpu_v5e_int8",), capacity=4, max_window=8),
               Pool("pod-bf16", ("tpu_v5e_bf16",), capacity=4, max_window=8),
               Pool("pod-mixed", ("tpu_v5e_int8", "tpu_v5e_bf16"),
                    capacity=4, max_window=8)],
        workload="transformer", arch="qwen3-14b", seq_len=512,
        cut_candidates=[1], accuracy_penalty={"tpu_v5e_int8": 0.015},
        slos=[dict(name="lm-interactive", max_latency_s=0.05,
                   max_accuracy_penalty=0.02, priority=1),
              dict(name="lm-batch", max_latency_s=1.0, max_energy_j=2.0)],
        faults=[Fault("pod-int8", at_s=1.0, duration_s=2.0)], trace=True)
    client = Fleet.from_dict(spec.to_dict()).build()
    pk["open_loop"](client, [client.resolve_slo("lm-interactive"),
                             client.resolve_slo("lm-batch")], [0.5, 0.5],
                    rate_hz=160.0, n_requests=300, seed=2)
    return client


def _live_mutation(pk):
    """The vision fleet grown and shrunk mid-run: a pool added, a board
    retired (it drains before it leaves), a capacity changed."""
    client = vision_spec(pk["FleetSpec"], pk["PoolSpec"],
                         pk["FaultSpec"]).build()
    classes = [pk["SLO_CLASSES"][n] for n in CLASS_NAMES]
    arrivals = pk["poisson_arrivals"](classes, [0.2, 0.3, 0.3, 0.2], 60.0,
                                      240, seed=4)
    i = 0
    while i < len(arrivals) or client.outstanding or client.pending_faults:
        client.advance()
        while i < len(arrivals) and arrivals[i][0] <= client.now:
            client.submit(slo=arrivals[i][1], arrival=arrivals[i][0])
            i += 1
        if i == 60 and "board-c" not in client.router.pools:
            client.add_pool(pk["PoolSpec"]("board-c", ("mpsoc_dpu",),
                                           capacity=1, max_window=2))
        if i == 120 and "board-a" in client.router.pools:
            client.retire_pool("board-a")
        if i == 180:
            client.set_capacity("sidecar", 3)
        client.pump()
    return client


def _retries(pk):
    """Bounded redispatch: board-b dies for good and the sidecar flaps,
    under a tight default retry policy, a per-class give-up-past-deadline
    policy and the client watchdog."""
    Fleet, Pool, Fault = pk["FleetSpec"], pk["PoolSpec"], pk["FaultSpec"]
    spec = vision_spec(Fleet, Pool, Fault)
    spec.faults = [Fault("board-b", at_s=0.5),
                   Fault("sidecar", at_s=0.6, duration_s=0.3),
                   Fault("sidecar", at_s=1.2, duration_s=0.3),
                   Fault("board-a", at_s=1.0, duration_s=0.4)]
    spec.retry = {"default": dict(max_attempts=2, backoff_s=0.1),
                  "realtime-tracking": dict(give_up_past_deadline=True)}
    spec.watchdog_s = 0.05
    client = Fleet.from_dict(spec.to_dict()).build()
    pk["open_loop"](client, [pk["SLO_CLASSES"][n] for n in CLASS_NAMES],
                    [0.2, 0.3, 0.3, 0.2], rate_hz=80.0, n_requests=200,
                    seed=8)
    return client


def _truncated(pk):
    """A run cut by ``open_loop``'s ``max_s`` safety net."""
    client = vision_spec(pk["FleetSpec"], pk["PoolSpec"],
                         pk["FaultSpec"]).build()
    with pytest.warns(RuntimeWarning, match="truncated"):
        h = pk["open_loop"](client, [pk["SLO_CLASSES"]["bulk-reprocess"]],
                            [1.0], rate_hz=50.0, n_requests=200, seed=1,
                            max_s=1.0)
    client.trunc = (h.truncated, h.unsubmitted, h.incomplete)
    return client


def _package(name):
    import importlib
    serving = importlib.import_module(f"{name}.serving")
    return {"FleetSpec": serving.FleetSpec, "PoolSpec": serving.PoolSpec,
            "FaultSpec": serving.FaultSpec, "open_loop": serving.open_loop,
            "poisson_arrivals": serving.poisson_arrivals,
            "SLO_CLASSES": serving.SLO_CLASSES}


SCENARIOS = {"lm_costmodel": _lm_costmodel, "live_mutation": _live_mutation,
             "retries": _retries, "truncated": _truncated}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_scenarios_equal_the_reference(scenario):
    runs = []
    for name in ("repro", "repro_torch"):
        client = SCENARIOS[scenario](_package(name))
        runs.append({
            "snapshot": client.telemetry,
            "timeseries": client.timeseries.to_dict(),
            "handles": [client.handle(rid).telemetry
                        for rid in sorted(client._handles)],
            "traces": [client.handle(rid).trace()
                       for rid in sorted(client._handles)],
            "pools": sorted(client.router.pools),
            "frontier": [(p.assignments, p.latency_s, p.energy_j)
                         for p in client.router.frontier],
            "trunc": getattr(client, "trunc", None)})
    want, got = runs
    snap = want["snapshot"]
    assert snap["admitted"] > 0
    if scenario == "live_mutation":
        assert snap["pools_added"] == 1 and snap["pools_retired"] == 1
        assert want["pools"] == ["board-b", "board-c", "sidecar"]
    if scenario == "retries":
        assert snap["retries"] > 0 and snap["dropped"] > 0
        assert snap["watchdog_trips"] > 0
    if scenario == "truncated":
        assert want["trunc"][0] and want["trunc"][1] > 0
    if scenario == "lm_costmodel":
        assert snap["failovers"] == 1 and snap["reschedules"] == 2
    for key in want:
        assert got[key] == want[key], key


def _random_layers(rng, n):
    return [(f"l{i}", float(rng.uniform(1e8, 5e10)),
             float(rng.uniform(1e4, 3e7)), float(rng.uniform(1e3, 1e7)),
             float(rng.uniform(1e3, 1e7)),
             "depthwise" if rng.random() < 0.2 else "dense")
            for i in range(n)]


def _plans(plans):
    return [(p.assignments, p.latency_s, p.energy_j, p.accuracy_penalty,
             [(c.name, c.compute_s, c.memory_s, c.handoff_s, c.energy_j)
              for c in p.segment_costs]) for p in plans]


@pytest.mark.parametrize("seed", range(4))
def test_frontier_and_failover_reschedule_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    rows = _random_layers(rng, int(rng.integers(3, 12)))
    jl = [JLayerCost(*r) for r in rows]
    tl = [TLayerCost(*r) for r in rows]
    names = sorted(PROFILES)
    profiles = list(rng.choice(names, int(rng.integers(2, 6)),
                               replace=False))
    lost = list(rng.choice(profiles, int(rng.integers(0, len(profiles))),
                           replace=False))
    penalty = {profiles[0]: float(rng.uniform(0, 0.3))}
    kw = dict(accuracy_penalty=penalty, batch=int(rng.integers(1, 5)))
    want = jsched.schedule(jl, profiles, **kw)
    got = tsched.schedule(tl, profiles, **kw)
    assert _plans(got) == _plans(want) and want
    want = jsched.reschedule_over_subset(jl, profiles, lost=lost, **kw)
    got = tsched.reschedule_over_subset(tl, profiles, lost=lost, **kw)
    assert _plans(got) == _plans(want) and want
    # the skyline sweep over a pool with dominated and tied plans
    pool = [jsched._plan_cost(jl, [c], [a, b], 1, penalty)
            for c in range(1, len(jl)) for a in profiles for b in profiles]
    tpool = [tsched._plan_cost(tl, [c], [a, b], 1, penalty)
             for c in range(1, len(tl)) for a in profiles for b in profiles]
    assert (_plans(tsched.pareto_frontier(tpool))
            == _plans(jsched.pareto_frontier(pool)))
    for plan, tplan in zip(want, got):
        for batch in (1, 3, 8):
            assert (tsched.price_assignments(tl, tplan, batch)
                    == jsched.price_assignments(jl, plan, batch))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cost_model_tables_equal_the_reference(arch):
    from repro.configs import get_config as jget
    for smoke in (False, True):
        want = jtlayers(jget(arch, smoke=smoke), seq_len=512)
        got = ttlayers(get_config(arch, smoke=smoke), seq_len=512)
        assert [tuple(vars(l).values()) for l in got] == \
            [tuple(vars(l).values()) for l in want]
    assert ([tuple(vars(l).values()) for l in tlayers(turso())]
            == [tuple(vars(l).values()) for l in jlayers(jurso())])


def reference_specs():
    """Fleet specs written by the reference: the vision fleet with an SLO
    spec, an LM cost-model fleet with custom classes, retry policies and a
    watchdog, and an engine fleet with every engine knob set."""
    lm = JFleet(
        pools=[JPool("pod-int8", ("tpu_v5e_int8",), capacity=4,
                     max_window=8),
               JPool("pod-bf16", ("tpu_v5e_bf16",), capacity=4,
                     max_window=8)],
        workload="transformer", arch="qwen3-14b", seq_len=256,
        cut_candidates=[1, 2, 3], accuracy_penalty={"tpu_v5e_int8": 0.015},
        slos=[dict(name="lm-interactive", max_latency_s=0.05,
                   max_accuracy_penalty=0.02, priority=1)],
        faults=[JFault("pod-int8", at_s=1.0, duration_s=2.0, kind="pool")],
        retry={"default": dict(max_attempts=3, backoff_s=0.1),
               "lm-interactive": dict(give_up_past_deadline=True)},
        watchdog_s=5.0, dt=0.005, latency_headroom=0.5)
    engines = JFleet(
        pools=[JPool("lm", ("tpu_v5e_bf16",), backend="engine",
                     max_slots=2, prompt_len=8, max_new=6, num_blocks=12,
                     plan="mpai", plan_split=1, max_prompt_len=20,
                     prefill_chunk=8, block_size=4),
               JPool("win", ("tpu_v5e_int8",), backend="windowed")],
        workload="transformer", smoke=True, arch="qwen3-14b")
    return [vision_spec(JFleet, JPool, JFault, slo=reference_slo()), lm,
            engines]


@pytest.mark.parametrize("which", range(3))
def test_reference_fleet_json_loads_unchanged(which):
    d = reference_specs()[which].to_dict()
    text = json.dumps(d)
    spec = TFleet.from_dict(json.loads(text))
    assert spec.to_dict() == d
    assert json.dumps(spec.to_dict()) == text
    spec.validate()
    with pytest.raises(ValueError, match="unknown key"):
        TFleet.from_dict({**d, "typo": 1})


def test_fleet_limits_validate_as_in_the_reference():
    bad = [dict(dt=0.0), dict(latency_headroom=-1.0),
           dict(watchdog_s=0.0), dict(retry={"x": {"max_attempts": 0}}),
           dict(retry={"x": {"nope": 1}})]
    for kw in bad:
        d = {**vision_spec(JFleet, JPool, JFault).to_dict(), **kw}
        with pytest.raises(ValueError) as want:
            JFleet.from_dict(d).validate()
        with pytest.raises(ValueError) as got:
            TFleet.from_dict(d).validate()
        assert str(got.value) == str(want.value)
    assert math.isinf(TFleet.from_dict(
        vision_spec(JFleet, JPool, JFault, fault_duration=math.inf)
        .to_dict()).faults[0].duration_s)
