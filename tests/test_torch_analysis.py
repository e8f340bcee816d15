"""fleetlint for the PyTorch port (``repro_torch.analysis``).

One bad fixture and one clean twin per pass (``tests/fixtures/
fleetlint_torch/``, and the reference's own fixtures for the passes the
port keeps as they are), the live port tree lint-clean against its
baseline, the canonical regressions injected into a copy of the tree,
and the port's analyzer held to the reference's: the same findings on
the reference fixtures, the same baseline keys, both packages' writers
against the golden telemetry sets, every reference jitted context and
every reference Pallas contract accounted for, and every ``extern "C"``
entry of ``kernels/csrc`` under a contract whose arity and kinds match.
Pure ``ast``: nothing is imported from the analysed packages but the
analyzers themselves.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.analysis import run_lint as ref_run_lint
from repro.analysis.passes import contracts as ref_contracts
from repro.analysis.passes import jitcheck as ref_jit
from repro_torch.analysis import (BaselineError, DEFAULT_BASELINE,
                                  load_baseline, run_lint)
from repro_torch.analysis.core import FileContext, default_root, find_def
from repro_torch.analysis.passes import contracts, hostsync, kernels

REPO = default_root()
FIXTURES = os.path.join(REPO, "tests", "fixtures", "fleetlint_torch")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "fleetlint")
KERNELS = "src/repro_torch/kernels"

#: reference baseline keys with no port counterpart under the same symbol
#: (the reference's dry run times ``analyze`` and ``main``; the port's
#: ``trace_cell`` times its own FakeTensorMode trace)
DRYRUN_KEYS = {
    "src/repro/launch/dryrun.py::VCP001::analyze":
        "the port's dry run has no analyze(): trace_cell times the trace",
    "src/repro/launch/dryrun.py::VCP001::main":
        "the port's CLI prints no wall duration of its own",
}
PORT_ONLY_KEYS = {"src/repro_torch/launch/dryrun.py::VCP001::trace_cell"}


def scratch_tree(tmp_path, files):
    for rel, content in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    return str(tmp_path)


def fixture(name, ref=False):
    with open(os.path.join(REF_FIXTURES if ref else FIXTURES, name)) as f:
        return f.read()


def read(rel):
    with open(os.path.join(REPO, rel)) as f:
        return f.read()


def lint_fixture(tmp_path, text, rel="src/repro_torch/fx/mod.py",
                 passes=None):
    root = scratch_tree(tmp_path, {rel: text})
    report = run_lint(root=root, baseline_path=None, passes=passes)
    return [f for f in report.findings if f.path == rel]


FX_PROGRAMS = tuple(
    hostsync.DeviceProgram("src/repro_torch/fx/mod.py", q, host_args=h)
    for q, h in (("step", ("budget",)), ("derived", ()),
                 ("Engine.decode", ())))
FX_STALE = hostsync.DeviceProgram("src/repro_torch/fx/mod.py", "gone")
FX_KERNEL = {"axpy_f32": contracts.KernelContract(
    module=f"{KERNELS}/axpy.py", wrapper="axpy",
    source=f"{KERNELS}/csrc/axpy.cu",
    argtypes=(contracts.PTR, contracts.PTR, contracts.INT, contracts.FLOAT,
              contracts.PTR),
    plain="axpy_plain", dead_entry_guard="table")}


# ---------------------------------------------------------------------------
# one bad fixture and one clean twin per pass
# ---------------------------------------------------------------------------
def _codes(tmp_path, monkeypatch, name):
    kind, variant = name.rsplit("_", 1)
    if kind == "hostsync":
        # the bad table also names a function the fixture lacks (SYN006)
        table = FX_PROGRAMS + ((FX_STALE,) if variant == "bad" else ())
        monkeypatch.setattr(hostsync, "DEVICE_PROGRAMS", table)
        found = lint_fixture(tmp_path, fixture(f"{name}.py"),
                             passes=["hostsync"])
        return {f.code for f in found}, found
    if kind == "kernel":
        monkeypatch.setattr(kernels, "KERNEL_CONTRACTS", FX_KERNEL)
        root = scratch_tree(tmp_path, {
            f"{KERNELS}/axpy.py": fixture(f"{name}.py"),
            f"{KERNELS}/csrc/axpy.cu": fixture(f"{name}.cu")})
        found = run_lint(root=root, baseline_path=None,
                         passes=["kernel"]).findings
        return {f.code for f in found}, found
    if kind == "telemetry":
        writers = fixture(f"{name}.py")
        root = scratch_tree(tmp_path, {
            "src/repro_torch/router/telemetry.py": writers,
            "src/repro_torch/obs/slo.py": writers,
            "tests/test_obs.py": fixture("telemetry_golden.py")})
        found = run_lint(root=root, baseline_path=None,
                         passes=["telemetry"]).findings
        return {f.code for f in found}, found
    ref = kind in ("alloc", "exc")       # the passes the port keeps as is
    found = lint_fixture(tmp_path, fixture(f"{name}.py", ref=ref))
    return {f.code for f in found}, found


@pytest.mark.parametrize("name,codes", [
    ("clock_bad", {"VCP001", "VCP002"}),
    ("hostsync_bad", {"SYN001", "SYN002", "SYN003", "SYN004", "SYN005",
                      "SYN006"}),
    ("alloc_bad", {"ALC001"}),
    ("exc_bad", {"EXC001", "EXC002"}),
    ("kernel_bad", {"KRN001", "KRN004", "KRN005", "KRN006", "KRN007",
                    "KRN008", "KRN009"}),
    ("telemetry_bad", {"TEL001", "TEL002"}),
])
def test_fixture_violations_all_detected(tmp_path, monkeypatch, name, codes):
    found, _ = _codes(tmp_path, monkeypatch, name)
    assert codes <= found, f"{name}: wanted {codes}, got {found}"


@pytest.mark.parametrize("name", ["clock_clean", "hostsync_clean",
                                  "alloc_clean", "exc_clean",
                                  "kernel_clean", "telemetry_clean"])
def test_clean_twins_produce_no_findings(tmp_path, monkeypatch, name):
    _, findings = _codes(tmp_path, monkeypatch, name)
    assert findings == [], findings


def test_clock_fixture_counts_every_torch_draw(tmp_path):
    found = lint_fixture(tmp_path, fixture("clock_bad.py"))
    assert sorted(f.symbol for f in found if f.code == "VCP002") == [
        "fill", "noise", "pick", "reseed", "tokens"]


def test_hostsync_fixture_names_each_site(tmp_path, monkeypatch):
    _, found = _codes(tmp_path, monkeypatch, "hostsync_bad")
    got = sorted((f.code, f.symbol) for f in found)
    assert got == [("SYN001", "Engine.decode"), ("SYN001", "derived"),
                   ("SYN001", "step"), ("SYN001", "step"),
                   ("SYN002", "step"), ("SYN003", "derived"),
                   ("SYN003", "derived"), ("SYN003", "step"),
                   ("SYN004", "step"),
                   ("SYN004", "step"), ("SYN005", "step"),
                   ("SYN006", "gone")]


# ---------------------------------------------------------------------------
# the live tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def live():
    return run_lint(root=REPO)


def test_live_tree_is_lint_clean_against_baseline(live):
    assert live.parse_errors == []
    assert live.stale_suppressions == []
    assert live.findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.code} {f.message}" for f in live.findings)
    assert live.files_scanned > 100


def test_no_baseline_shows_exactly_the_baselined_keys(live):
    entries = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    unsuppressed = run_lint(root=REPO, baseline_path=None)
    assert {f.key for f in unsuppressed.findings} == set(entries)
    assert {f.key for f, _ in live.suppressed} == set(entries)
    assert len(entries) == 15
    for key, reason in entries.items():
        assert key.count("::") == 2 and "::VCP001::" in key, key
        assert reason.strip(), key


# ---------------------------------------------------------------------------
# the injected regressions
# ---------------------------------------------------------------------------
def _copy_kernels(tmp_path):
    shutil.copytree(os.path.join(REPO, KERNELS), tmp_path / KERNELS,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return str(tmp_path)


def _kernel_findings(root):
    return run_lint(root=root, baseline_path=None,
                    passes=["kernel"]).findings


def test_injected_wall_clock_in_router_dispatch_is_caught(tmp_path):
    rel = "src/repro_torch/router/dispatch.py"
    src = read(rel)
    assert "import time" not in src
    src = src.replace("from __future__ import annotations",
                      "from __future__ import annotations\nimport time", 1)
    src += "\n\ndef _leak():\n    return time.time()\n"
    hits = [f for f in lint_fixture(tmp_path, src, rel=rel)
            if f.code == "VCP001"]
    assert [f.symbol for f in hits] == ["_leak"]


def test_injected_item_in_a_device_program_is_caught(tmp_path):
    rel = "src/repro_torch/runtime/serve.py"
    src = read(rel)
    marker = "        if not sampled:\n            return torch.argmax"
    assert marker in src
    src = src.replace(marker, "        _sync = logits.max().item()\n"
                      + marker, 1)
    hits = [f for f in lint_fixture(tmp_path, src, rel=rel,
                                    passes=["hostsync"])
            if f.code == "SYN001"]
    assert [f.symbol for f in hits] == ["ContinuousBatchingEngine._pick"]


def test_injected_global_torch_draw_in_traffic_is_caught(tmp_path):
    rel = "src/repro_torch/serving/traffic.py"
    src = read(rel).replace("import numpy as np",
                            "import numpy as np\nimport torch", 1)
    src += "\n\ndef _jitter(n):\n    return torch.rand(n)\n"
    hits = [f for f in lint_fixture(tmp_path, src, rel=rel)
            if f.code == "VCP002"]
    assert [f.symbol for f in hits] == ["_jitter"]


def test_injected_short_argtypes_in_paged_attention_is_caught(tmp_path):
    root = _copy_kernels(tmp_path)
    p = tmp_path / KERNELS / "paged_attention.py"
    good = "[ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]"
    assert good in p.read_text()
    p.write_text(p.read_text().replace(
        good, "[ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + "
              "[ctypes.c_void_p]"))
    assert [(f.code, f.symbol) for f in _kernel_findings(root)] == [
        ("KRN004", "paged_attention_bf16")]


def test_renamed_extern_symbol_is_caught(tmp_path):
    root = _copy_kernels(tmp_path)
    p = tmp_path / KERNELS / "csrc" / "wkv.cu"
    p.write_text(p.read_text().replace("int wkv_f32(", "int wkv_f32x("))
    got = {(f.code, f.symbol) for f in _kernel_findings(root)}
    assert got == {("KRN003", "wkv_f32"), ("KRN001", "wkv_f32x")}


def test_dropped_build_check_is_caught(tmp_path):
    root = _copy_kernels(tmp_path)
    p = tmp_path / KERNELS / "int8_matmul.py"
    src = p.read_text()
    assert "build.check(fn(x.data_ptr()" in src
    p.write_text(src.replace("build.check(fn(x.data_ptr()",
                             "(fn(x.data_ptr()"))
    assert [(f.code, f.symbol) for f in _kernel_findings(root)] == [
        ("KRN007", "int8_matmul")]


def test_unclamped_block_table_read_is_caught(tmp_path):
    root = _copy_kernels(tmp_path)
    p = tmp_path / KERNELS / "csrc" / "paged_attention.cu"
    src = p.read_text()
    assert "max(__ldg(trow + tok / page), 0)" in src
    p.write_text(src.replace("max(__ldg(trow + tok / page), 0)",
                             "__ldg(trow + tok / page)"))
    assert [(f.code, f.symbol) for f in _kernel_findings(root)] == [
        ("KRN009", "paged_attention_bf16")]


def test_plain_fallback_on_a_cuda_tensor_is_caught(tmp_path):
    root = _copy_kernels(tmp_path)
    p = tmp_path / KERNELS / "quant.py"
    src = p.read_text()
    marker = "    if not x.is_cuda:\n        return rowwise_quant_plain(x)\n"
    assert marker in src
    p.write_text(src.replace(marker, "").replace(
        "    fn = build.entry(\"rowwise_quant\", \"rowwise_quant\"",
        "    if x.numel() > 2 ** 30:\n"
        "        return rowwise_quant_plain(x)\n"
        "    fn = build.entry(\"rowwise_quant\", \"rowwise_quant\""))
    got = [(f.code, f.symbol) for f in _kernel_findings(root)]
    assert got == [("KRN008", "rowwise_quant")] * 2  # no route; a fallback


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,rel", [
    ("clock_bad.py", "fx/mod.py"), ("clock_clean.py", "fx/mod.py"),
    ("alloc_bad.py", "fx/mod.py"), ("alloc_clean.py", "fx/mod.py"),
    ("exc_bad.py", "fx/mod.py"), ("exc_clean.py", "fx/mod.py"),
    ("exc_clean.py", "router/worker.py"), ("jit_bad.py", "fx/mod.py"),
])
def test_same_findings_as_the_reference_on_its_fixtures(tmp_path, name,
                                                         rel):
    text = fixture(name, ref=True)
    ref_rel, port_rel = f"src/repro/{rel}", f"src/repro_torch/{rel}"
    root = scratch_tree(tmp_path, {ref_rel: text, port_rel: text})
    passes = ["clock", "alloc", "exc"]
    ref = ref_run_lint(root=root, baseline_path=None, passes=passes)
    port = run_lint(root=root, baseline_path=None, passes=passes)
    want = [(f.code, f.line, f.symbol) for f in ref.findings
            if f.path == ref_rel]
    assert [(f.code, f.line, f.symbol) for f in port.findings
            if f.path == port_rel] == want
    if name.endswith("_bad.py") and name != "jit_bad.py":
        assert want


def test_baseline_keys_map_back_to_the_references(live):
    port = load_baseline(os.path.join(REPO, DEFAULT_BASELINE))
    ref = load_baseline(os.path.join(REPO, "src/repro/analysis/"
                                           "baseline.json"))
    mapped = {k.replace("src/repro_torch/", "src/repro/", 1)
              for k in set(port) - PORT_ONLY_KEYS}
    assert mapped == set(ref) - set(DRYRUN_KEYS)
    assert set(DRYRUN_KEYS) <= set(ref) and PORT_ONLY_KEYS <= set(port)


def test_both_packages_writers_match_the_golden_sets():
    for lint in (ref_run_lint, run_lint):
        report = lint(root=REPO, baseline_path=None, passes=["telemetry"])
        assert report.findings == [], report.findings


def _reference_jit_contexts():
    """``path::qualname`` of every jitted context the reference's jit
    pass finds in src/repro."""
    found = []

    def spy(ctx, aliases, scopes, fn, traced):
        name = getattr(fn, "name", "<lambda>")
        scope = ctx.symbol(fn)
        found.append(f"{ctx.rel}::{scope + '.' if scope else ''}{name}")
        return []

    real = ref_jit._check_body
    ref_jit._check_body = spy
    try:
        ref_run_lint(root=REPO, baseline_path=None, passes=["jit"])
    finally:
        ref_jit._check_body = real
    return set(found)


def test_every_reference_jitted_context_is_accounted_for():
    contexts = _reference_jit_contexts()
    assert len(contexts) >= 25
    covered = hostsync.covered_reference_contexts()
    missing = contexts - covered - set(hostsync.NO_DEVICE_PROGRAM)
    assert not missing, sorted(missing)
    # every name the table cites is a real reference context
    assert covered | set(hostsync.NO_DEVICE_PROGRAM) <= contexts


def test_every_device_program_exists_in_the_port():
    for e in hostsync.DEVICE_PROGRAMS:
        ctx = FileContext(REPO, e.path, read(e.path))
        assert find_def(ctx.tree, e.qualname) is not None, e


def test_every_reference_kernel_contract_has_a_port_counterpart():
    for name in ref_contracts.KERNEL_CONTRACTS:
        entries = contracts.counterparts(name)
        assert entries, name
        assert all(s in contracts.KERNEL_CONTRACTS for s in entries)


def test_every_c_entry_has_a_matching_contract():
    csrc = os.path.join(REPO, KERNELS, "csrc")
    entries = {}
    for fname in sorted(os.listdir(csrc)):
        if fname.endswith(".cu"):
            with open(os.path.join(csrc, fname)) as f:
                for sym, (ret, kinds, _) in kernels.extern_entries(
                        f.read()).items():
                    entries[sym] = (f"{KERNELS}/csrc/{fname}", ret, kinds)
    assert len(entries) == 14
    assert set(entries) == set(contracts.KERNEL_CONTRACTS)
    for sym, (src, ret, kinds) in entries.items():
        c = contracts.KERNEL_CONTRACTS[sym]
        assert (src, ret, tuple(kinds)) == (c.source, "int", c.argtypes), sym


def test_every_entry_site_is_one_of_eleven():
    sites = 0
    for fname in os.listdir(os.path.join(REPO, KERNELS)):
        if fname.endswith(".py"):
            tree = ast.parse(read(f"{KERNELS}/{fname}"))
            sites += sum(isinstance(n, ast.Call)
                         and isinstance(n.func, ast.Attribute)
                         and n.func.attr == "entry" for n in ast.walk(tree))
    assert sites == 11


def test_c_reader_kinds():
    text = ('/* extern "C" int hidden(int x) {} */\n'
            'extern "C" int f(const void* __restrict__ a, int n, float s,\n'
            '                 long long st, int64_t o, void* stream) {}\n'
            'extern "C" void g(void) {}\n')
    got = kernels.extern_entries(text)
    assert got == {"f": ("int", ["ptr", "int", "float", "int64", "int64",
                                 "ptr"], 2),
                   "g": ("void", [], 4)}


# ---------------------------------------------------------------------------
# baseline rules and the CLI
# ---------------------------------------------------------------------------
def test_suppression_round_trip_and_stale_entries(tmp_path):
    rel = "src/repro_torch/fx/mod.py"
    root = scratch_tree(tmp_path, {rel: fixture("clock_bad.py")})
    keys = sorted({f.key for f in run_lint(root=root,
                                           baseline_path=None).findings})
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"suppressions": [
        {"key": k, "reason": "fixture"} for k in keys + [f"{rel}::X::gone"]]}))
    full = run_lint(root=root, baseline_path=str(baseline))
    assert full.findings == [] and full.stale_suppressions == [
        f"{rel}::X::gone"]
    sliced = run_lint(root=root, files=[rel], baseline_path=str(baseline))
    assert sliced.clean


def test_baseline_entry_without_reason_is_rejected(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"suppressions": [{"key": "a::VCP001::b",
                                               "reason": " "}]}))
    with pytest.raises(BaselineError, match="no reason"):
        load_baseline(str(p))


def test_diff_slice_with_a_cuda_source_runs_only_the_kernel_pass(tmp_path):
    root = _copy_kernels(tmp_path)
    rel = f"{KERNELS}/csrc/wkv.cu"
    report = run_lint(root=root, files=[rel], baseline_path=None)
    assert report.files_scanned == 0 and report.parse_errors == []
    assert report.findings == []
    p = tmp_path / rel
    p.write_text(p.read_text().replace("int wkv_f32(", "int wkv_f32x("))
    report = run_lint(root=root, files=[rel], baseline_path=None)
    assert {f.code for f in report.findings} == {"KRN001", "KRN003"}


def _cli(args, module=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    cmd = ([sys.executable, "-m", "repro_torch.analysis"] if module else
           [sys.executable, os.path.join(REPO, "tools", "fleetlint_torch.py")])
    return subprocess.run(cmd + args, capture_output=True, text=True,
                          env=env, cwd=REPO)


def test_cli_exit_codes(tmp_path):
    root = scratch_tree(tmp_path, {"src/repro_torch/fx/mod.py":
                                   fixture("clock_bad.py")})
    res = _cli(["--root", root, "--no-baseline", "--json",
                "--pass", "clock"])
    assert res.returncode == 1
    payload = json.loads(res.stdout)
    assert payload["counts"]["by_pass"]["clock"] == 6
    assert _cli(["--pass", "nope"]).returncode == 2


def test_launcher_exits_zero_on_the_live_tree():
    res = _cli([], module=False)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 findings, 30 suppressed, 0 stale" in res.stdout
