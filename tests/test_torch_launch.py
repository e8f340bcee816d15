"""The port's launchers (``repro_torch.launch``) against ``repro.launch``.

The cost-model launchers are plain Python on the fleet's virtual clock, so
both packages run in this process and give the same results: the eclipse
scenario with and without the controller (its report, and the Chrome trace
it writes), the route demo's vision and LM cost-model sections, the
dashboard's frames (``top.render``) and final report, and the orbit and
dashboard CLIs' printed output.  ``chip_smoke.py``'s digests of the
launchers' default runs are the reference's.  The launchers that decode run
on the CPU only when asked (``--device cpu``): ``serve.main`` at the
``qwen3-14b`` smoke config and ``route.lm_execute_section`` serve as many
requests and tokens as the reference's (the two packages' seed-0 inits
differ, so tokens are not compared), and without a card and without
``--device cpu`` both stop."""
import argparse
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _launch(name):
    import importlib
    return {m: importlib.import_module(f"{name}.launch.{m}")
            for m in ("orbit", "route", "top", "serve")}


@pytest.fixture(scope="module")
def ref():
    return _launch("repro")


@pytest.fixture(scope="module")
def port():
    return _launch("repro_torch")


@pytest.mark.parametrize("controlled,scale,n", [(True, True, 120),
                                                (False, True, 120),
                                                (True, False, 80)])
def test_eclipse_scenario_equals_the_reference(ref, port, controlled, scale,
                                               n):
    kw = dict(n_requests=n, controlled=controlled, scale=scale, seed=2)
    want = ref["orbit"].run_eclipse_scenario(**kw)
    assert port["orbit"].run_eclipse_scenario(**kw) == want
    assert want["unresolved_handles"] == 0


def test_traced_eclipse_scenario_equals_the_reference(ref, port, tmp_path):
    want = ref["orbit"].run_eclipse_scenario(
        n_requests=100, trace_path=str(tmp_path / "j.json"))
    got = port["orbit"].run_eclipse_scenario(
        n_requests=100, trace_path=str(tmp_path / "t.json"))
    assert got.pop("trace_path") == str(tmp_path / "t.json")
    want.pop("trace_path")
    assert got == want and want["trace_events"] > 0
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_chip_smoke_digests_are_the_references(ref):
    """``chip_smoke.py`` holds the port's default launcher runs on the card
    to these digests of the reference's."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    reports = {}
    for controlled in (True, False):
        r = ref["orbit"].run_eclipse_scenario(controlled=controlled)
        reports[r["scenario"]] = r
    frames = []
    reports["top_report"] = ref["top"].run_dashboard(emit=frames.append)
    reports["top_frames"] = frames
    assert reports["orbit_eclipse_on"]["energy_ratio"] == 0.9787
    assert {k: chip_smoke.digest(v) for k, v in reports.items()} == \
        chip_smoke.VISION_ORBIT_DIGESTS


def _route_args(**kw):
    args = dict(requests=150, rate=40.0, fault_at=3.0, fault_duration=4.0,
                seed=0, arch="qwen3-14b", seq=512, max_new=4,
                windowed_lm=False, device="cpu")
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("kw", [{}, dict(seed=3, fault_duration=20.0),
                                dict(rate=90.0, fault_at=1.0)])
def test_route_sections_equal_the_reference(ref, port, kw):
    args = _route_args(**kw)
    want = ref["route"].vision_section(args)
    assert port["route"].vision_section(args) == want
    assert want["failovers"] >= 1
    assert port["route"].lm_section(args) == ref["route"].lm_section(args)


@pytest.mark.parametrize("every", [0.5, 2.0])
def test_dashboard_frames_equal_the_reference(ref, port, every):
    want, got = [], []
    r_want = ref["top"].run_dashboard(n_requests=100, every_s=every,
                                      emit=want.append)
    r_got = port["top"].run_dashboard(n_requests=100, every_s=every,
                                      emit=got.append)
    assert got == want and r_got == r_want
    assert any("mode=" in f for f in want)


def test_render_equals_the_reference_on_a_live_fleet(ref, port):
    """``render`` on fleets without a controller or an SLO engine, and
    with both, mid-run."""
    frames = []
    for pk in (ref, port):
        spec = pk["route"].vision_fleet_spec()
        plain = spec.build()
        spec.slo = pk["top"].health_slo_spec()
        full = spec.build()
        pk["orbit"].eclipse_orbit_spec(
            pk["orbit"].mix_demand_w(full, 60.0)).attach(full)
        out = [pk["top"].render(plain)]
        for client in (plain, full):
            for i in range(60):
                client.submit(slo=pk["orbit"].MIX[i % 3][0])
                client.step(0.01)
        out += [pk["top"].render(plain), pk["top"].render(full)]
        frames.append(out)
    assert frames[1] == frames[0]


@pytest.mark.parametrize("launcher,argv", [
    ("orbit", ["--requests", "90", "--json"]),
    ("orbit", ["--requests", "90", "--uncontrolled", "--no-scale"]),
    ("top", ["--requests", "90", "--json"]),
    ("top", ["--requests", "60", "--every", "0.5"])])
def test_cli_output_equals_the_reference(ref, port, launcher, argv,
                                         monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [launcher] + argv)
    ref[launcher].main()
    want = capsys.readouterr().out
    port[launcher].main(argv)
    assert capsys.readouterr().out == want and want


def _served(line):
    m = re.search(r"served (\d+) requests / (\d+) tokens in (\d+) batches",
                  line)
    return tuple(int(g) for g in m.groups())


def test_serve_smoke_on_the_cpu_serves_as_the_reference(ref, port,
                                                        monkeypatch, capsys,
                                                        tmp_path):
    argv = ["--arch", "qwen3-14b", "--smoke", "--plan", "mpai",
            "--requests", "6", "--max-new", "5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    ref["serve"].main()
    want = _served(capsys.readouterr().out)
    out = port["serve"].main(argv + ["--device", "cpu", "--trace",
                                     str(tmp_path / "t.json")])
    text = capsys.readouterr().out
    assert _served(text) == want == (6, 30, want[2])
    assert out["served"] == 6 and out["tokens"] == [5] * 6
    trace = json.loads((tmp_path / "t.json").read_text())
    assert len(trace["traceEvents"]) == out["trace_events"]
    assert "serve" in {e["args"]["name"] for e in trace["traceEvents"]
                       if e["name"] == "process_name"}


def test_lm_execute_section_on_the_cpu_serves_as_the_reference(ref, port):
    args = _route_args(requests=6, max_new=3)
    want = ref["route"].lm_execute_section(args)
    got = port["route"].lm_execute_section(args)
    keys = ("admitted", "completed", "dropped", "generated_tokens")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert want["generated_tokens"] == 18


@pytest.mark.parametrize("launcher,argv", [
    ("serve", ["--arch", "qwen3-14b", "--smoke"]),
    ("route", ["--requests", "10", "--execute-lm"])])
def test_decoding_launchers_refuse_to_fall_back_to_the_cpu(
        port, launcher, argv, monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port[launcher].main(argv)
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
