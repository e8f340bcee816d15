"""Pass 5b — telemetry-schema drift (TEL), a project pass.

The port's snapshot schema is held to the reference's own contract:
the golden sets are read (as text, with ``ast``; the test module is
never imported) from the reference's ``tests/test_obs.py``, and the
writers are the port's ``router/telemetry.py`` and ``obs/slo.py``.

``tests/test_obs.py`` pins the snapshot schema as golden set literals
(``FLEET_KEYS`` / ``POOL_KEYS`` / ``HIST_KEYS`` / ``DROP_REASONS`` /
``SLI_KEYS`` / ``SLI_SCOPES`` / ``ALERT_KEYS``) — the contract the
orbit controller, benches, and CI gates read.  But the golden test only
fails at *test time* on a traffic shape that exercises the key; this
pass closes the gap statically by diffing the dict literals in
``router/telemetry.py`` and ``obs/slo.py`` against the golden sets:

* ``TEL001`` — key written by ``Telemetry.snapshot()`` /
  ``PoolCounters.summary()`` / ``Histogram.summary()`` /
  ``SLIScope.summary()`` / ``SLIRegistry.summary()`` /
  ``AlertBus.snapshot()`` / the ``drops_by_reason`` zero-init that is
  **absent** from the golden set (schema grew without updating the
  contract).
* ``TEL002`` — golden key no monitored writer produces (schema
  shrank / key renamed — every dashboard reading it now KeyErrors).
* ``TEL003`` — a monitored writer or golden set could not be located
  at all (the pass itself went stale; fix the extraction anchors).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from repro_torch.analysis.core import FileContext, Finding, project_pass

TELEMETRY_FILE = "src/repro_torch/router/telemetry.py"
SLO_FILE = "src/repro_torch/obs/slo.py"
GOLDEN_FILE = "tests/test_obs.py"

#: (file, class, method) -> golden set-literal name in the test file
WRITERS = {
    (TELEMETRY_FILE, "Telemetry", "snapshot"): "FLEET_KEYS",
    (TELEMETRY_FILE, "PoolCounters", "summary"): "POOL_KEYS",
    (TELEMETRY_FILE, "Histogram", "summary"): "HIST_KEYS",
    (SLO_FILE, "SLIScope", "summary"): "SLI_KEYS",
    (SLO_FILE, "SLIRegistry", "summary"): "SLI_SCOPES",
    (SLO_FILE, "AlertBus", "snapshot"): "ALERT_KEYS",
}
#: the zero-init reason dict must cover at least the golden reasons
DROPS_ATTR = "drops_by_reason"
DROPS_GOLDEN = "DROP_REASONS"


def _dict_keys(node: ast.AST) -> Optional[Set[str]]:
    if isinstance(node, ast.Dict):
        keys = set()
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
            else:
                return None          # computed key — can't check statically
        return keys
    return None


def _return_dict_keys(fn: ast.FunctionDef) -> Optional[Set[str]]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            keys = _dict_keys(node.value)
            if keys is not None:
                return keys
    return None


def _golden_sets(tree: ast.AST) -> Dict[str, Set[str]]:
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if isinstance(node.value, ast.Set):
                vals = {e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)}
                out[tgt.id] = vals
    return out


@project_pass("telemetry")
def telemetry_pass(root: str) -> List[Finding]:
    findings: List[Finding] = []

    def read(rel: str) -> Optional[FileContext]:
        p = os.path.join(root, rel.replace("/", os.sep))
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return FileContext(root, rel, f.read())

    tctx = read(TELEMETRY_FILE)
    gctx = read(GOLDEN_FILE)
    if tctx is None or gctx is None:
        missing = TELEMETRY_FILE if tctx is None else GOLDEN_FILE
        return [Finding("telemetry", "TEL003", missing, 0,
                        f"telemetry pass anchor {missing} not found")]
    golden = _golden_sets(gctx.tree)

    # file -> class -> method defs, for every monitored writer file
    writer_files = sorted({f for f, _, _ in WRITERS})
    methods: Dict[str, Dict[str, Dict[str, ast.FunctionDef]]] = {}
    for rel in writer_files:
        ctx = tctx if rel == TELEMETRY_FILE else read(rel)
        if ctx is None:
            findings.append(Finding(
                "telemetry", "TEL003", rel, 0,
                f"telemetry pass anchor {rel} not found — re-anchor the "
                f"WRITERS table in passes/telemetry.py"))
            continue
        methods[rel] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                methods[rel][node.name] = {
                    n.name: n for n in node.body
                    if isinstance(n, ast.FunctionDef)}

    for (rel, cls, meth), golden_name in WRITERS.items():
        if rel not in methods:
            continue                  # missing file already reported
        fn = methods[rel].get(cls, {}).get(meth)
        want = golden.get(golden_name)
        if fn is None or want is None:
            where = (f"{cls}.{meth}" if fn is None
                     else f"{GOLDEN_FILE}:{golden_name}")
            findings.append(Finding(
                "telemetry", "TEL003", rel, 0,
                f"telemetry pass anchor {where} not found — re-anchor "
                f"the WRITERS table in passes/telemetry.py",
                symbol=f"{cls}.{meth}"))
            continue
        got = _return_dict_keys(fn)
        if got is None:
            continue                  # non-literal return: golden test covers it
        for key in sorted(got - want):
            findings.append(Finding(
                "telemetry", "TEL001", rel, fn.lineno,
                f"{cls}.{meth}() writes key {key!r} that is missing from "
                f"{golden_name} in {GOLDEN_FILE} — add it to the golden "
                f"schema in the same change", symbol=f"{cls}.{meth}"))
        for key in sorted(want - got):
            findings.append(Finding(
                "telemetry", "TEL002", rel, fn.lineno,
                f"golden key {key!r} in {golden_name} has no writer in "
                f"{cls}.{meth}() — consumers reading it will KeyError",
                symbol=f"{cls}.{meth}"))

    # drops_by_reason zero-init must cover the golden reason codes
    want = golden.get(DROPS_GOLDEN)
    init_keys: Optional[Set[str]] = None
    init_line = 0
    for node in ast.walk(tctx.tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute)
                        and tgt.attr == DROPS_ATTR):
                    init_keys = _dict_keys(node.value)
                    init_line = node.lineno
        elif isinstance(node, ast.AnnAssign):
            tgt = node.target
            if (isinstance(tgt, ast.Attribute) and tgt.attr == DROPS_ATTR
                    and node.value is not None):
                init_keys = _dict_keys(node.value)
                init_line = node.lineno
    if want is None or init_keys is None:
        findings.append(Finding(
            "telemetry", "TEL003", TELEMETRY_FILE, 0,
            f"telemetry pass anchor {DROPS_ATTR} zero-init or "
            f"{DROPS_GOLDEN} golden set not found"))
    else:
        for key in sorted(init_keys - want):
            findings.append(Finding(
                "telemetry", "TEL001", TELEMETRY_FILE, init_line,
                f"drop reason {key!r} zero-initialized but missing from "
                f"{DROPS_GOLDEN} in {GOLDEN_FILE}", symbol="Telemetry"))
        for key in sorted(want - init_keys):
            findings.append(Finding(
                "telemetry", "TEL002", TELEMETRY_FILE, init_line,
                f"golden drop reason {key!r} is not zero-initialized in "
                f"{DROPS_ATTR} — the snapshot schema is traffic-dependent "
                f"for it", symbol="Telemetry"))
    return findings
