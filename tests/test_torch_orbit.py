"""The port's orbit control plane (``repro_torch.orbit``) against
``repro.orbit``.

On cost-model fleets (the route demo's vision fleet and a one-board burst
fleet) both packages run in this process — the control plane has no
framework code — and each of ``tests/test_orbit.py``'s scenarios gives the
same controller report, snapshot, mode transitions, scale actions, handle
telemetry and span trees: the power profile's integrals and ``budget_j``,
the energy bucket under the same seeded operation lists, energy-first plan
choice in conserve mode, the two-state router mirror, eclipse deferral then
completion, critical-mode rejection, the storm ladder, live add / retire /
``set_capacity``, the autoscaler's grow, shrink and capacity modes, growth
held off nominal, attaching after the fleet ran, and the validation errors.
An ``OrbitSpec`` the reference wrote loads into the port and gives back the
same dict.

On an engine fleet (``tiny_dense`` with the reference's weights through
``repro_torch.bridge``, an orbit with an autoscaler over the engine pool)
the reference runs in a subprocess with XLA's excess precision off, and
both packages' ``serving.executor.time`` are one stub clock
(``test_torch_facade_engine.StubClock``), because an engine batch's latency
is its wall time: the greedy tokens, the controller's report and
transitions (the engines' wall-clock floats left out), the prepay charged
at admission and refunded at settlement, and the bucket's books are the
reference's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
from test_torch_facade_engine import WALL_CLOCK, StubClock  # noqa: E402

PACKAGES = ("repro", "repro_torch")


def _package(name):
    import importlib
    orbit = importlib.import_module(f"{name}.orbit")
    serving = importlib.import_module(f"{name}.serving")
    router = importlib.import_module(f"{name}.router")
    route = importlib.import_module(f"{name}.launch.route")
    sched = importlib.import_module(f"{name}.core.scheduler")
    return {"orbit": orbit, "Fleet": serving.FleetSpec,
            "Pool": serving.PoolSpec, "SLOClass": router.SLOClass,
            "vision": route.vision_fleet_spec,
            "ScheduledPlan": sched.ScheduledPlan}


def _both(fn):
    """``fn(pk)`` in the reference, then in the port."""
    return [fn(_package(name)) for name in PACKAGES]


def _client_state(client, ctrl=None):
    """Everything a cost-model run's comparison reads."""
    rids = sorted(client._handles)
    out = {"snapshot": client.telemetry,
           "timeseries": client.timeseries.to_dict(),
           "handles": [client.handle(r).telemetry for r in rids],
           "traces": [client.handle(r).trace() for r in rids],
           "pools": sorted(client.router.pools),
           "capacity": {n: p.capacity
                        for n, p in sorted(client.router.pools.items())},
           "energy_mode": client.router.energy_mode, "now": client.now}
    if ctrl is not None:
        out["report"] = ctrl.report()
        out["transitions"] = list(ctrl.transitions)
        out["storm"] = ctrl.storm
    return out


def _assert_equal(want, got):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# power profile and bucket
# ---------------------------------------------------------------------------
def _profile(o):
    return o.PowerProfile([o.OrbitPhase("sunlit", 2.0, 10.0),
                           o.OrbitPhase("eclipse", 3.0, 1.0),
                           o.OrbitPhase("penumbra", 0.7, 4.5)])


def test_power_profile_integrals_and_budget_equal_the_reference():
    rng = np.random.default_rng(0)
    spans = [(0.0, 5.0), (1.0, 7.0), (0.0, 11.5), (3.0, 3.0), (4.9, 4.2),
             (5.7, 5.7 + 1e-9)] + [tuple(sorted(rng.uniform(0, 40, 2)))
                                   for _ in range(40)]

    def run(pk):
        o = pk["orbit"]
        p = _profile(o)
        return {"period": p.period_s, "avg": p.orbit_average_w,
                "cycle": p.cycle_j,
                "power": [p.power_at(t) for t in np.linspace(0, 17, 69)],
                "phase": [p.phase_at(t).name for t in (0.0, 2.0, 5.0, 5.7,
                                                       11.4, 11.39)],
                "energy": [p.energy_between(a, b) for a, b in spans],
                "budget": [o.budget_j(p, 7.0, a, b) for a, b in spans]}
    want, got = _both(run)
    assert want["energy"][1] == pytest.approx(29.15)   # 10 + 3 + 3.15 + 13
    _assert_equal(want, got)


@pytest.mark.parametrize("seed", range(6))
def test_bucket_levels_equal_under_the_same_ops(seed):
    """``test_bucket_level_never_negative_never_over_capacity``'s property,
    on seeded op lists (advance, drain, refund, rebase) through both
    packages' buckets: the same levels and books after every op."""
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(4)), float(rng.uniform(0, 5)),
            float(rng.uniform(0, 50))) for _ in range(60)]

    def run(pk):
        o = pk["orbit"]
        b = o.EnergyBucket(20.0, _profile(o), level_j=5.0)
        t, seen = 0.0, []
        for op, dt, j in ops:
            t += dt
            ret = (b.advance(t) if op == 0 else b.drain(j) if op == 1
                   else b.refund(j / 4) if op == 2 else b.rebase(t))
            assert 0.0 <= b.level_j <= b.capacity_j
            seen.append((ret, b.level_j, b.frac, b.summary()))
        return seen
    want, got = _both(run)
    assert got == want


def test_bucket_clip_accounting_equals_the_reference():
    def run(pk):
        o = pk["orbit"]
        b = o.EnergyBucket(10.0, None, level_j=4.0)
        b2 = o.EnergyBucket(10.0, _profile(o), level_j=10.0)
        return [b.drain(6.0), b.summary(), b2.advance(1.0), b2.summary(),
                o.EnergyBucket(3.0, None, level_j=-1.0).level_j,
                o.EnergyBucket(3.0, None, level_j=9.0).level_j]
    want, got = _both(run)
    assert want[0] == 4.0
    assert got == want


# ---------------------------------------------------------------------------
# controller scenarios on cost-model fleets
# ---------------------------------------------------------------------------
def _conserve_plan_choice(pk):
    client = pk["vision"]().build()
    router = client.router
    Plan = pk["ScheduledPlan"]
    fast = Plan(((0, 6, "mpsoc_dpu"),), 0.1, 5.0, 0.0)
    cheap = Plan(((0, 6, "mpsoc_dpu"),), 0.5, 1.0, 0.0)
    router.frontier = [fast, cheap]
    slo = pk["SLOClass"]("eclipse-test", max_latency_s=0.6)
    picks = [router._choose(slo)[0]]
    router.energy_mode = "conserve"
    picks.append(router._choose(slo)[0])
    return {"picks": [(p.latency_s, p.energy_j) for p in picks]}


def _router_mirror(pk):
    o = pk["orbit"]
    client = pk["vision"]()
    client.trace = True
    client = client.build()
    ctrl = o.OrbitSpec(phases=[o.PhaseSpec("eclipse", 10.0, 0.0)],
                       bucket_j=10.0, initial_frac=0.3, conserve_frac=0.5,
                       critical_frac=0.05).attach(client)
    modes = [(ctrl.mode, client.router.energy_mode)]
    ctrl.bucket.drain(ctrl.bucket.level_j)
    client.step()
    modes.append((ctrl.mode, client.router.energy_mode))
    return {"modes": modes, **_client_state(client, ctrl)}


def _eclipse_defers(pk):
    o = pk["orbit"]
    client = pk["vision"]().build()
    client.enable_tracing()
    ctrl = o.OrbitSpec(phases=[o.PhaseSpec("eclipse", 1.0, 0.0),
                               o.PhaseSpec("sunlit", 9.0, 100.0)],
                       bucket_j=1.0, initial_frac=0.2, conserve_frac=0.5,
                       critical_frac=0.01).attach(client)
    offline = client.submit(slo="bulk-reprocess")
    critical = client.submit(slo="downlink-critical")
    mid = (offline.admitted, offline.done, offline.telemetry["deferred"],
           client.telemetry)
    rs = [critical.result(), offline.result(max_s=30.0)]
    return {"mid": mid, "results": [(r.rid, r.admitted, r.latency_s,
                                     r.dropped, r.pool) for r in rs],
            **_client_state(client, ctrl)}


def _critical_rejects(pk):
    o = pk["orbit"]
    client = pk["vision"]().build()
    client.enable_tracing()
    ctrl = o.OrbitSpec(phases=[o.PhaseSpec("eclipse", 100.0, 0.0)],
                       bucket_j=1.0, initial_frac=0.0, conserve_frac=0.5,
                       critical_frac=0.1).attach(client)
    offline = client.submit(slo="bulk-reprocess")
    critical = client.submit(slo="downlink-critical")
    return {"admitted": [offline.admitted, offline.done, critical.admitted],
            **_client_state(client, ctrl)}


def _storm(pk):
    o = pk["orbit"]
    client = pk["vision"]().build()
    client.enable_tracing()
    ctrl = o.OrbitSpec(phases=[o.PhaseSpec("sunlit", 100.0, 1000.0)],
                       bucket_j=100.0, storm_events=1,
                       storm_decay=0.8).attach(client)
    seen = [(ctrl.mode, ctrl.storm, ctrl.storm_pressure)]
    client.router.telemetry.retries += 3         # storm: retry burst
    handles = [client.submit(slo=s) for s in ("bulk-reprocess",
                                              "downlink-critical")]
    for _ in range(50):
        client.step()
        seen.append((ctrl.mode, ctrl.storm, ctrl.storm_pressure))
    client.router.telemetry.pools["board-a"].bitflips_detected += 2
    for _ in range(30):
        client.step()
        seen.append((ctrl.mode, ctrl.storm, ctrl.storm_pressure))
    assert all(h.done for h in handles)
    return {"seen": seen, **_client_state(client, ctrl)}


def _live_add_retire(pk):
    client = pk["vision"]().build()
    client.enable_tracing()
    Pool = pk["Pool"]
    client.add_pool(Pool("board-a/as0", ("mpsoc_dpu", "myriadx_vpu"),
                         capacity=2, max_window=4))
    handles = [client.submit(slo="downlink-critical") for _ in range(12)]
    by_pool = [h._rreq.pool for h in handles]
    client.retire_pool("board-a/as0")
    client.set_capacity("board-b", 5)
    client.drain()
    client.step()
    return {"by_pool": by_pool, **_client_state(client)}


def _burst_spec(pk):
    return pk["Fleet"](pools=[pk["Pool"]("board", ("mpsoc_dpu",),
                                         capacity=1, max_window=2,
                                         max_wait_s=0.0)],
                       workload="ursonet")


def _autoscale_pools(pk):
    o = pk["orbit"]
    client = _burst_spec(pk).build()
    client.enable_tracing()
    ctrl = o.OrbitSpec(
        phases=[o.PhaseSpec("sunlit", 100.0, 1e9)], bucket_j=1e9,
        scaling=o.ScalingPolicy(template="board", min_pools=1, max_pools=3,
                                queue_high=4, queue_low=0,
                                cooldown_s=0.01)).attach(client)
    for _ in range(16):
        client.submit(slo="bulk-reprocess")
    client.drain()
    for _ in range(200):
        client.step()
    return _client_state(client, ctrl)


def _autoscale_capacity(pk):
    o = pk["orbit"]
    client = _burst_spec(pk).build()
    client.enable_tracing()
    ctrl = o.OrbitSpec(
        phases=[o.PhaseSpec("sunlit", 100.0, 1e9)], bucket_j=1e9,
        scaling=o.ScalingPolicy(template="board", queue_high=4, queue_low=0,
                                cooldown_s=0.01, grow="capacity",
                                max_capacity=4)).attach(client)
    for _ in range(16):
        client.submit(slo="bulk-reprocess")
    client.drain()
    grown = client.router.pools["board"].capacity
    for _ in range(400):
        client.step()
    return {"grown": grown, **_client_state(client, ctrl)}


def _autoscale_held_off_nominal(pk):
    o = pk["orbit"]
    client = _burst_spec(pk).build()
    client.enable_tracing()
    ctrl = o.OrbitSpec(
        phases=[o.PhaseSpec("eclipse", 100.0, 0.0)], bucket_j=1.0,
        initial_frac=0.2,
        scaling=o.ScalingPolicy(template="board", queue_high=2,
                                cooldown_s=0.0)).attach(client)
    for _ in range(8):
        client.submit(slo="downlink-critical")
    for _ in range(20):
        client.step()
    return _client_state(client, ctrl)


def _attach_after_advance(pk):
    o = pk["orbit"]
    client = pk["vision"]().build()
    client.step(50.0)
    ctrl = o.OrbitSpec(phases=[o.PhaseSpec("sunlit", 100.0, 1000.0)],
                       bucket_j=100.0, initial_frac=0.1).attach(client)
    client.step()
    return _client_state(client, ctrl)


SCENARIOS = {"router_mirror": _router_mirror,
             "eclipse_defers": _eclipse_defers,
             "critical_rejects": _critical_rejects, "storm": _storm,
             "live_add_retire": _live_add_retire,
             "autoscale_pools": _autoscale_pools,
             "autoscale_capacity": _autoscale_capacity,
             "autoscale_held_off_nominal": _autoscale_held_off_nominal,
             "attach_after_advance": _attach_after_advance}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_orbit_scenarios_equal_the_reference(scenario):
    want, got = _both(SCENARIOS[scenario])
    # each scenario shows what ``tests/test_orbit.py`` asserts of it
    snap = want["snapshot"]
    if scenario == "router_mirror":
        assert want["modes"] == [("conserve", "conserve"),
                                 ("critical", "conserve")]
    elif scenario == "eclipse_defers":
        assert snap["energy_deferred"] == 1 and snap["completed"] == 2
        assert want["results"][1][2] > 0.9
    elif scenario == "critical_rejects":
        assert want["admitted"] == [True, False, False]
        assert snap["energy_rejected"] == 1
    elif scenario == "storm":
        modes = [m for m, _, _ in want["seen"]]
        assert "conserve" in modes and modes[-1] == "nominal"
        assert sum(1 for _, storm, _ in want["seen"] if storm) >= 2
    elif scenario == "live_add_retire":
        assert "board-a/as0" in want["by_pool"]
        assert snap["pools_retired"] == 1 and want["capacity"]["board-b"] == 5
    elif scenario == "autoscale_pools":
        ops = [a["op"] for a in want["report"]["scale_actions"]]
        assert "add" in ops and "retire" in ops
        assert want["pools"] == ["board"] and snap["completed"] == 16
    elif scenario == "autoscale_capacity":
        assert want["grown"] > 1 and want["capacity"] == {"board": 1}
    elif scenario == "autoscale_held_off_nominal":
        assert want["report"]["mode"] != "nominal"
        assert snap["pools_added"] == 0
    elif scenario == "attach_after_advance":
        assert want["report"]["bucket"]["level_j"] == pytest.approx(12.0)
    _assert_equal(want, got)


def test_conserve_mode_plan_choice_equals_the_reference():
    want, got = _both(_conserve_plan_choice)
    assert want["picks"] == [(0.1, 5.0), (0.5, 1.0)]
    assert got == want


# ---------------------------------------------------------------------------
# OrbitSpec as data
# ---------------------------------------------------------------------------
def _reference_orbit_specs():
    from repro.orbit import OrbitSpec, PhaseSpec, ScalingPolicy
    return [OrbitSpec(phases=[PhaseSpec("sunlit", 60.0, 8.0),
                              PhaseSpec("eclipse", 35.0, 1.5)],
                      bucket_j=120.0, initial_frac=0.8, conserve_frac=0.4,
                      critical_frac=0.1, hysteresis_frac=0.02,
                      defer_max_priority=1,
                      scaling=ScalingPolicy(template="board-a", max_pools=4,
                                            queue_high=5, grow="capacity")),
            OrbitSpec(phases=[PhaseSpec("sunlit", 1.0, 1.0)], bucket_j=1.0),
            OrbitSpec(phases=[PhaseSpec("sunlit", 100.0, 1000.0)],
                      bucket_j=100.0, storm_events=1, storm_decay=0.8)]


@pytest.mark.parametrize("which", range(3))
def test_reference_orbit_spec_loads_unchanged(which):
    from repro_torch.orbit import OrbitSpec
    ref = _reference_orbit_specs()[which]
    d = json.loads(json.dumps(ref.to_dict()))
    spec = OrbitSpec.from_dict(d)
    assert spec.to_dict() == ref.to_dict()
    assert spec.profile().orbit_average_w == ref.profile().orbit_average_w
    assert spec.bucket().summary() == ref.bucket().summary()


def _errors(pk):
    """Every validation error the reference's tests pin, as text."""
    o = pk["orbit"]
    out = []

    def catch(fn):
        try:
            fn()
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    P = o.PhaseSpec
    catch(lambda: o.OrbitSpec(phases=[P("s", 1.0, 1.0)], bucket_j=1.0,
                              conserve_frac=0.2, critical_frac=0.5))
    catch(lambda: o.OrbitSpec(phases=[P("s", 1.0, 1.0)], bucket_j=1.0,
                              storm_decay=1.0))
    catch(lambda: o.OrbitSpec(phases=[P("s", 1.0, 1.0)], bucket_j=1.0,
                              hysteresis_frac=-0.1))
    catch(lambda: o.OrbitSpec(phases=[], bucket_j=100.0).validate())
    for kw in (dict(phases=[P("sunlit", 0.0, 8.0)], bucket_j=10.0),
               dict(phases=[P("sunlit", 60.0, -1.0)], bucket_j=10.0),
               dict(phases=[P("sunlit", 60.0, 8.0)], bucket_j=0.0),
               dict(phases=[P("sunlit", 60.0, 8.0)], bucket_j=10.0,
                    initial_frac=1.5),
               dict(phases=[P("sunlit", 60.0, 8.0)], bucket_j=10.0,
                    storm_events=-1)):
        catch(lambda kw=kw: o.OrbitSpec(**kw).validate())
    spec = o.OrbitSpec(phases=[P("sunlit", 60.0, 8.0)], bucket_j=120.0)
    d = spec.to_dict()
    d["bucket_joules"] = 1.0
    catch(lambda: o.OrbitSpec.from_dict(d))
    d = spec.to_dict()
    d["phases"][0]["duration"] = 60.0
    catch(lambda: o.OrbitSpec.from_dict(d))
    for kw in (dict(grow="sideways"), dict(min_pools=0),
               dict(max_pools=0), dict(queue_low=8),
               dict(min_capacity=3, max_capacity=2),
               dict(capacity_step=0)):
        catch(lambda kw=kw: o.ScalingPolicy(template="board", **kw))
    catch(lambda: o.OrbitPhase("x", 0.0, 1.0))
    catch(lambda: o.OrbitPhase("x", 1.0, -1.0))
    catch(lambda: o.PowerProfile([]))
    catch(lambda: o.EnergyBucket(0.0))
    client = pk["vision"]().build()
    catch(lambda: o.OrbitSpec(phases=[P("sunlit", 60.0, 8.0)],
                              bucket_j=-5.0).attach(client))
    catch(lambda: o.OrbitSpec(phases=[P("sunlit", 60.0, 8.0)], bucket_j=5.0,
                              scaling=o.ScalingPolicy(template="nope")
                              ).attach(client))
    catch(lambda: o.Autoscaler(o.ScalingPolicy(template="a"),
                               pk["Pool"]("b", ("mpsoc_dpu",))))
    return out


def test_validation_errors_equal_the_reference():
    want, got = _both(_errors)
    assert None not in want
    assert got == want


def test_orbit_exports_the_reference_names():
    import repro.orbit as jo
    import repro_torch.orbit as to
    assert to.__all__ == jo.__all__
    assert to.MODES == jo.MODES


# ---------------------------------------------------------------------------
# an engine fleet through an eclipse, the reference in a subprocess
# ---------------------------------------------------------------------------
N_LM, MAX_NEW = 12, 6


def engine_spec(Fleet, Pool):
    """One bf16 engine pool of ``tiny_dense`` and an LM class of priority 1
    beside the default ``offline`` one (priority 0, deferrable)."""
    return Fleet(pools=[Pool("lm", ("tpu_v5e_bf16",), backend="engine",
                             capacity=1, max_window=4, max_wait_s=0.0,
                             max_slots=3, prompt_len=8, max_new=MAX_NEW)],
                 workload="transformer", seq_len=8, trace=True,
                 slos=[dict(name="lm-critical", max_latency_s=600.0,
                            priority=1)])


def engine_run(pk_orbit, pk_open_loop, client):
    """Attach an orbit sized in units of the frontier's cheapest plan (one
    prepay ``unit`` = ``floor * MAX_NEW``), submit one request and read the
    prepay, then a seeded open loop over both classes and an idle tail;
    returns what the comparison reads."""
    o = pk_orbit
    floor = min(p.energy_j for p in client.router.frontier)
    unit = floor * MAX_NEW
    ctrl = o.OrbitSpec(
        phases=[o.PhaseSpec("sunlit", 0.3, 40 * unit),
                o.PhaseSpec("eclipse", 0.9, 0.0)],
        bucket_j=6 * unit,
        scaling=o.ScalingPolicy(template="lm", max_pools=2, queue_high=2,
                                queue_low=0, cooldown_s=0.05),
    ).attach(client)
    rng = np.random.default_rng(4)
    first = client.submit(rng.integers(0, 256, 5).astype(np.int32),
                          slo="offline", max_new=MAX_NEW)
    prepay = {"report": ctrl.report(), "prepaid": dict(ctrl._prepaid)}

    def prompt(r):
        return r.integers(0, 256, int(r.integers(2, 8))).astype(np.int32)
    handles = [first] + list(pk_open_loop(
        client, [client.resolve_slo("offline"),
                 client.resolve_slo("lm-critical")], [0.6, 0.4],
        rate_hz=30.0, n_requests=N_LM, seed=7, payload_fn=prompt))
    for _ in range(300):
        client.step()
    spans = []
    for sp in client.tracer.spans:
        d = sp.to_dict()
        if d["stage"] in ENGINE_STAGES:
            del d["t0"], d["t1"]
        spans.append(d)
    return {"unit": unit, "prepay": prepay,
            "handles": [{**h.telemetry, "tokens": [int(t) for t in h.tokens],
                         "done": h.done} for h in handles],
            "report": ctrl.report(), "transitions": list(ctrl.transitions),
            "prepaid_left": dict(ctrl._prepaid),
            "snapshot": client.telemetry, "spans": spans,
            "open_spans": len(client.tracer.open_spans())}


ENGINE_STAGES = ("admit", "prefill_chunk", "decode_step")


def _reference(out):
    import jax
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro import orbit as jorbit
    from repro.models import transformer as JT
    from repro.serving import FleetSpec, PoolSpec, executor, open_loop
    from conftest import tiny_dense

    out = Path(out)
    params = JT.model_init(jax.random.PRNGKey(0), tiny_dense())
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    np.savez(out / "params.npz", **flat)
    spec = engine_spec(FleetSpec, PoolSpec)
    executor.time = StubClock()
    client = FleetSpec.from_dict(spec.to_dict()).build(
        model=(tiny_dense(), params))
    res = {"spec": spec.to_dict(),
           "run": engine_run(jorbit, open_loop, client)}
    (out / "ref.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def engine_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("orbit_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(d)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    tree = {}
    for key, a in np.load(d / "params.npz").items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return json.loads((d / "ref.json").read_text()), tree


@pytest.fixture(scope="module")
def engine_port(engine_ref):
    from repro_torch import bridge, orbit
    from repro_torch.configs.tiny import TINY
    from repro_torch.serving import FleetSpec, executor, open_loop
    real = executor.time
    executor.time = StubClock()
    try:
        client = FleetSpec.from_dict(engine_ref[0]["spec"]).build(
            model=(TINY, bridge.to_torch(engine_ref[1], "cpu")),
            device="cpu")
        return json.loads(json.dumps(engine_run(orbit, open_loop, client)))
    finally:
        executor.time = real


def _compare(got, want, path=""):
    """Same keys at every depth; every value equal but ``WALL_CLOCK``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k not in WALL_CLOCK:
                _compare(got[k], want[k], f"{path}/{k}")
        return
    assert got == want, (path, got, want)


def test_engine_orbit_exercises_the_control_plane(engine_ref):
    run = engine_ref[0]["run"]
    modes = [m for _, m in run["transitions"]]
    assert modes[0] == "nominal" and "nominal" in modes[1:]
    assert any(m != "nominal" for m in modes)
    snap = run["snapshot"]
    assert snap["energy_deferred"] >= 1
    assert snap["pools_added"] >= 1
    assert snap["pools_retired"] == snap["pools_added"]
    assert all(h["done"] for h in run["handles"])
    assert run["open_spans"] == 0 and not run["prepaid_left"]
    assert run["prepay"]["report"]["prepaid_j"] > 0


def test_engine_orbit_tokens_equal_the_reference(engine_ref, engine_port):
    want, got = engine_ref[0]["run"]["handles"], engine_port["handles"]
    assert [h["tokens"] for h in got] == [h["tokens"] for h in want], (
        "greedy streams differ; check the reference's top-2 logit margin "
        "at the first divergent token (ROADMAP, 'Greedy near-ties')")
    _compare(got, want, "handles")


@pytest.mark.parametrize("key", ["report", "transitions", "prepay",
                                 "prepaid_left", "snapshot", "spans", "unit"])
def test_engine_orbit_equals_the_reference(engine_ref, engine_port, key):
    _compare(engine_port[key], engine_ref[0]["run"][key], key)


if __name__ == "__main__":
    _reference(sys.argv[1])
