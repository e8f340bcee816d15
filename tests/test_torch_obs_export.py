"""The port's exporters (``repro_torch.obs.metrics`` and ``.export``)
against ``repro.obs``: the route demo's vision fleet under its two faults,
with an ``SLOSpec``, the orbit controller (an eclipse, the autoscaler on
board-a) and the flight recorder attached, driven by the same seeded open
loop in both packages in this process.  The Prometheus dump is byte-equal,
the SLO report equal, the Chrome trace equal as parsed JSON (every event,
in order: pool lanes, stage rows, orbit phases, counter tracks) and the
spans file equal line for line — in memory and as written by the
``export_*`` functions."""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_facade_control import (CLASS_NAMES,  # noqa: E402
                                       reference_slo, vision_spec)

PACKAGES = ("repro", "repro_torch")


def _package(name):
    import importlib
    return {m: importlib.import_module(f"{name}.{m}")
            for m in ("obs", "orbit", "serving")}


def _run(pk, seed, rate, orbit, slo):
    """Build the reference spec's JSON in ``pk``'s package, attach the
    orbit, drive the open loop and an idle tail."""
    serving, o = pk["serving"], pk["orbit"]
    spec = vision_spec(serving.FleetSpec, serving.PoolSpec,
                       serving.FaultSpec, slo=reference_slo() if slo
                       else None)
    client = serving.FleetSpec.from_dict(
        json.loads(json.dumps(spec.to_dict()))).build()
    if orbit:
        o.OrbitSpec(phases=[o.PhaseSpec("sunlit", 1.0, 40.0),
                            o.PhaseSpec("eclipse", 3.0, 2.0)],
                    bucket_j=8.0, storm_events=2,
                    scaling=o.ScalingPolicy(template="board-a", max_pools=3,
                                            queue_high=4, cooldown_s=0.1)
                    ).attach(client)
    serving.open_loop(client, [serving.SLO_CLASSES[n] for n in CLASS_NAMES],
                      [0.2, 0.3, 0.3, 0.2], rate_hz=rate, n_requests=240,
                      seed=seed)
    for _ in range(100):
        client.step()
    return client


CASES = [(0, 40.0, True, True), (3, 60.0, True, False),
         (11, 120.0, False, True), (5, 40.0, False, False)]


@pytest.fixture(scope="module", params=CASES,
                ids=["orbit_slo", "orbit", "slo", "plain"])
def clients(request):
    seed, rate, orbit, slo = request.param
    out = [_run(_package(n), seed, rate, orbit, slo) for n in PACKAGES]
    snap = out[0].telemetry
    assert snap["failovers"] == 2 and snap["completed"] > 0
    assert not out[0].tracer.open_spans()
    if orbit:
        assert snap["energy_deferred"] > 0
    if orbit and not slo:
        assert snap["pools_added"] > 0
    if slo:
        # the burn alerts page, which also holds the autoscaler's growth
        assert snap["alerts"]["pages_fired"] > 0
    return [(_package(n), c) for n, c in zip(PACKAGES, out)]


def test_prometheus_text_is_byte_equal(clients, tmp_path):
    (jpk, jc), (tpk, tc) = clients
    want = jpk["obs"].prometheus_text(jc)
    assert "repro_fleet_events_total" in want
    assert tpk["obs"].prometheus_text(tc) == want
    got = tpk["obs"].export_prometheus(tc, str(tmp_path / "t.prom"))
    jpk["obs"].export_prometheus(jc, str(tmp_path / "j.prom"))
    assert got == want
    assert (tmp_path / "t.prom").read_bytes() == \
        (tmp_path / "j.prom").read_bytes()


def test_slo_report_is_equal(clients, tmp_path):
    (jpk, jc), (tpk, tc) = clients
    assert tpk["obs"].slo_report(tc) == jpk["obs"].slo_report(jc)
    assert tpk["obs"].slo_report(tc, t_end=3.25) == \
        jpk["obs"].slo_report(jc, t_end=3.25)
    got = tpk["obs"].export_slo_report(tc, str(tmp_path / "t.json"))
    want = jpk["obs"].export_slo_report(jc, str(tmp_path / "j.json"))
    assert got == want
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_chrome_trace_is_equal_as_parsed_json(clients, tmp_path):
    (jpk, jc), (tpk, tc) = clients
    got = tpk["obs"].export_chrome_trace(tc, tmp_path / "t.json")
    want = jpk["obs"].export_chrome_trace(jc, tmp_path / "j.json")
    assert got == want
    parsed = json.loads((tmp_path / "t.json").read_text())
    assert parsed == json.loads((tmp_path / "j.json").read_text())
    names = {e["args"]["name"] for e in parsed["traceEvents"]
             if e["name"] == "process_name"}
    assert {"fleet", "board-a", "board-b", "sidecar"} <= names
    # the pure trace function, with and without the optional tracks
    for kw in ({}, {"t_end": 2.0}):
        assert tpk["obs"].chrome_trace(tc.tracer, **kw) == \
            jpk["obs"].chrome_trace(jc.tracer, **kw)


def test_spans_jsonl_is_equal_line_for_line(clients, tmp_path):
    (jpk, jc), (tpk, tc) = clients
    n = tpk["obs"].export_spans_jsonl(tc, tmp_path / "t.jsonl")
    assert n == jpk["obs"].export_spans_jsonl(jc, tmp_path / "j.jsonl") > 0
    got = (tmp_path / "t.jsonl").read_text().splitlines()
    assert got == (tmp_path / "j.jsonl").read_text().splitlines()
    assert len(got) == n


def test_obs_exports_the_reference_names():
    import repro.obs as jo
    import repro_torch.obs as to
    assert to.__all__ == jo.__all__
