"""fleetlint core for the PyTorch port: finding model, pass registry,
baseline, and runner.

The analyzer is pure ``ast`` — nothing is imported, compiled or
launched, so a lint run cannot be perturbed by (or perturb) torch or
CUDA state, and it runs in a fraction of a second before any test or
benchmark spins up.  Passes come in two shapes:

* **file passes** get one parsed module at a time (clock purity, host
  syncs in device programs, allocator encapsulation, exception
  hygiene);
* **project passes** get the repo root and cross-reference several
  files (the ctypes entry sites in ``kernels/`` vs the ``extern "C"``
  entries of ``kernels/csrc/*.cu`` and the contract table, the
  telemetry schema vs the golden test).

Findings are identified by a *stable key* ``path::CODE::symbol`` (the
enclosing function/class qualname, falling back to the line number), so
the checked-in baseline survives unrelated edits to the same file.
Every baseline entry must carry a non-empty ``reason`` — the allowlist
is documentation, not a mute button — and entries that no longer match
anything are reported as stale so the file can only shrink.
"""
from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

LINT_VERSION = 1

#: subtree of the repo the analyzer walks (repo-relative, posix)
SOURCE_ROOT = "src/repro_torch"


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Finding:
    """One invariant violation at one site."""
    pass_id: str          # "clock" | "jit" | "alloc" | "kernel" | ...
    code: str             # e.g. "VCP001"
    path: str             # repo-relative posix path
    line: int
    message: str
    symbol: str = ""      # enclosing def/class qualname ("" = module level)

    @property
    def key(self) -> str:
        """Stable suppression key (symbol-scoped, line-independent)."""
        anchor = self.symbol if self.symbol else f"L{self.line}"
        return f"{self.path}::{self.code}::{anchor}"

    def to_dict(self) -> Dict:
        return {"pass": self.pass_id, "code": self.code, "path": self.path,
                "line": self.line, "symbol": self.symbol,
                "message": self.message, "key": self.key}


class FileContext:
    """One parsed source file handed to every file pass."""

    def __init__(self, root: str, rel: str, source: str,
                 tree: Optional[ast.AST] = None):
        self.root = root
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.tree = tree if tree is not None else ast.parse(source, rel)
        self._annotate_symbols()

    def _annotate_symbols(self) -> None:
        """Stamp every node with its enclosing def/class qualname."""
        def walk(node: ast.AST, stack: Tuple[str, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                nstack = stack
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    nstack = stack + (child.name,)
                child._fl_qual = ".".join(stack)       # enclosing scope
                walk(child, nstack)
        self.tree._fl_qual = ""
        walk(self.tree, ())

    def symbol(self, node: ast.AST) -> str:
        return getattr(node, "_fl_qual", "")

    def finding(self, pass_id: str, code: str, node: ast.AST,
                message: str) -> Finding:
        return Finding(pass_id, code, self.rel,
                       getattr(node, "lineno", 0), message,
                       symbol=self.symbol(node))


def find_def(tree: ast.AST, qualname: str):
    """The def named by a dotted ``qualname`` (``fn``, ``Class.method``,
    ``outer.inner``), or None."""
    scope = tree
    for part in qualname.split("."):
        scope = next((n for n in ast.iter_child_nodes(scope)
                      if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                        ast.ClassDef)) and n.name == part),
                     None)
        if scope is None:
            return None
    return scope if isinstance(scope, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) else None


# ---------------------------------------------------------------------------
# pass registry
# ---------------------------------------------------------------------------
FilePass = Callable[[FileContext], List[Finding]]
ProjectPass = Callable[[str], List[Finding]]

FILE_PASSES: Dict[str, FilePass] = {}
PROJECT_PASSES: Dict[str, ProjectPass] = {}


def file_pass(name: str):
    def deco(fn: FilePass) -> FilePass:
        FILE_PASSES[name] = fn
        return fn
    return deco


def project_pass(name: str):
    def deco(fn: ProjectPass) -> ProjectPass:
        PROJECT_PASSES[name] = fn
        return fn
    return deco


def _load_passes() -> None:
    """Import the pass modules (registration is a side effect)."""
    from repro_torch.analysis.passes import (  # noqa: F401
        allocator, clock, hostsync, hygiene, kernels, telemetry)


# ---------------------------------------------------------------------------
# baseline / suppressions
# ---------------------------------------------------------------------------
DEFAULT_BASELINE = os.path.join("src", "repro_torch", "analysis",
                                "baseline.json")


class BaselineError(ValueError):
    """Malformed suppression file — fail the run, never skip silently."""


def load_baseline(path: str) -> Dict[str, str]:
    """Load ``{key: reason}``; every entry must carry a reason."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "suppressions" not in data:
        raise BaselineError(f"{path}: expected {{'suppressions': [...]}}")
    out: Dict[str, str] = {}
    for i, entry in enumerate(data["suppressions"]):
        key = entry.get("key")
        reason = entry.get("reason", "")
        if not key or not isinstance(key, str):
            raise BaselineError(f"{path}: suppression #{i} has no key")
        if not reason or not str(reason).strip():
            raise BaselineError(
                f"{path}: suppression {key!r} has no reason — every "
                f"allowlist entry must justify itself")
        if key in out:
            raise BaselineError(f"{path}: duplicate suppression {key!r}")
        out[key] = str(reason)
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
@dataclass
class Report:
    root: str
    findings: List[Finding] = field(default_factory=list)     # unsuppressed
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)
    stale_suppressions: List[str] = field(default_factory=list)
    parse_errors: List[Tuple[str, str]] = field(default_factory=list)
    files_scanned: int = 0

    @property
    def clean(self) -> bool:
        return not (self.findings or self.stale_suppressions
                    or self.parse_errors)

    def to_dict(self) -> Dict:
        by_pass: Dict[str, int] = {}
        for f in self.findings:
            by_pass[f.pass_id] = by_pass.get(f.pass_id, 0) + 1
        return {
            "version": LINT_VERSION,
            "root": self.root,
            "files_scanned": self.files_scanned,
            "clean": self.clean,
            "counts": {"findings": len(self.findings),
                       "suppressed": len(self.suppressed),
                       "stale_suppressions": len(self.stale_suppressions),
                       "parse_errors": len(self.parse_errors),
                       "by_pass": dict(sorted(by_pass.items()))},
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [{**f.to_dict(), "reason": r}
                           for f, r in self.suppressed],
            "stale_suppressions": list(self.stale_suppressions),
            "parse_errors": [{"path": p, "error": e}
                             for p, e in self.parse_errors],
        }


def default_root() -> str:
    """Repo root = parent of the ``src`` directory this package lives in."""
    here = os.path.dirname(os.path.abspath(__file__))   # .../src/repro_torch/analysis
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def iter_source_files(root: str) -> List[str]:
    """Repo-relative paths of every python file under ``src/repro_torch``."""
    base = os.path.join(root, *SOURCE_ROOT.split("/"))
    out = []
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                out.append(rel.replace(os.sep, "/"))
    return out


def lint_file(root: str, rel: str,
              passes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the file passes over one file (``rel`` repo-relative)."""
    _load_passes()
    with open(os.path.join(root, rel.replace("/", os.sep))) as f:
        source = f.read()
    ctx = FileContext(root, rel, source)
    findings: List[Finding] = []
    for name, fn in FILE_PASSES.items():
        if passes is None or name in passes:
            findings.extend(fn(ctx))
    return findings


def run_lint(root: Optional[str] = None,
             files: Optional[Sequence[str]] = None,
             baseline_path: Optional[str] = DEFAULT_BASELINE,
             passes: Optional[Sequence[str]] = None) -> Report:
    """Lint the tree (or just ``files``) and apply the baseline.

    ``files`` restricts the *file* passes (``--diff`` mode) to its
    python files; project passes still run whenever one of ``files`` is
    among their subject files (a ``.cu`` source included) — they are
    whole-repo invariants and cheap.  ``baseline_path`` is
    repo-relative (or absolute); ``None`` disables suppression.
    """
    _load_passes()
    root = root if root is not None else default_root()
    report = Report(root=root)

    rels = list(files) if files is not None else iter_source_files(root)
    raw: List[Finding] = []
    for rel in rels:
        rel = rel.replace(os.sep, "/")
        if not rel.endswith(".py"):
            continue                 # a .cu source: project passes only
        try:
            with open(os.path.join(root, rel.replace("/", os.sep))) as f:
                source = f.read()
            ctx = FileContext(root, rel, source)
        except (OSError, SyntaxError) as e:
            report.parse_errors.append((rel, str(e)))
            continue
        report.files_scanned += 1
        for name, fn in FILE_PASSES.items():
            if passes is None or name in passes:
                raw.extend(fn(ctx))

    for name, fn in PROJECT_PASSES.items():
        if passes is not None and name not in passes:
            continue
        if files is not None and not _project_pass_in_scope(name, rels):
            continue
        raw.extend(fn(root))

    raw.sort(key=lambda f: (f.path, f.line, f.code))

    suppressions: Dict[str, str] = {}
    if baseline_path is not None:
        bp = (baseline_path if os.path.isabs(baseline_path)
              else os.path.join(root, baseline_path))
        if os.path.exists(bp):
            suppressions = load_baseline(bp)

    used = set()
    for f in raw:
        reason = suppressions.get(f.key)
        if reason is not None:
            report.suppressed.append((f, reason))
            used.add(f.key)
        else:
            report.findings.append(f)
    # stale entries only assessable on a full run: a --diff slice that
    # skips a file must not report its suppressions as dead
    if files is None:
        report.stale_suppressions = sorted(set(suppressions) - used)
    return report


#: project passes only fire in --diff mode when a file they read changed
_PROJECT_SCOPE = {
    "kernel": ("src/repro_torch/kernels/",          # csrc/*.cu included
               "src/repro_torch/analysis/passes/contracts.py"),
    "hostsync": ("src/repro_torch/analysis/passes/hostsync.py",),
    "telemetry": ("src/repro_torch/router/telemetry.py",
                  "src/repro_torch/obs/slo.py", "tests/test_obs.py"),
}


def _project_pass_in_scope(name: str, rels: Iterable[str]) -> bool:
    prefixes = _PROJECT_SCOPE.get(name)
    if prefixes is None:
        return True
    return any(r.startswith(p) for r in rels for p in prefixes)
