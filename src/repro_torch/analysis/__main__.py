"""fleetlint CLI: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean, 1 findings (or stale suppressions / parse
errors), 2 usage or baseline-format error.  ``--json`` emits the full
machine-readable report (``--output FILE`` writes the same payload).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.core import (DEFAULT_BASELINE, FILE_PASSES,
                                 PROJECT_PASSES, BaselineError, Report,
                                 _load_passes, default_root, run_lint)


def _format_text(report: Report) -> str:
    lines: List[str] = []
    for f in report.findings:
        sym = f" [{f.symbol}]" if f.symbol else ""
        lines.append(f"{f.path}:{f.line}: {f.code}{sym} {f.message}")
    for key in report.stale_suppressions:
        lines.append(f"baseline: stale suppression {key!r} — remove it")
    for path, err in report.parse_errors:
        lines.append(f"{path}: parse error: {err}")
    n = len(report.findings)
    lines.append(
        f"fleetlint: {report.files_scanned} files, {n} finding"
        f"{'' if n == 1 else 's'}, {len(report.suppressed)} suppressed, "
        f"{len(report.stale_suppressions)} stale")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="fleetlint — static invariant analyzer for src/repro_torch")
    parser.add_argument("paths", nargs="*",
                        help="repo-relative files to lint (default: all of "
                             "src/repro_torch)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: autodetected)")
    parser.add_argument("--json", action="store_true",
                        help="emit the machine-readable report")
    parser.add_argument("--output", default=None, metavar="FILE",
                        help="also write the JSON report to FILE")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="suppression file (repo-relative)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (show every finding)")
    parser.add_argument("--pass", dest="passes", action="append",
                        default=None, metavar="NAME",
                        help="run only this pass (repeatable)")
    parser.add_argument("--list-passes", action="store_true")
    args = parser.parse_args(argv)

    _load_passes()
    if args.list_passes:
        for name in sorted(FILE_PASSES):
            print(f"{name}\t(file pass)")
        for name in sorted(PROJECT_PASSES):
            print(f"{name}\t(project pass)")
        return 0

    known = set(FILE_PASSES) | set(PROJECT_PASSES)
    if args.passes and not set(args.passes) <= known:
        bad = sorted(set(args.passes) - known)
        print(f"fleetlint: unknown pass(es) {bad}; known: {sorted(known)}",
              file=sys.stderr)
        return 2

    try:
        report = run_lint(
            root=args.root if args.root is not None else default_root(),
            files=args.paths if args.paths else None,
            baseline_path=None if args.no_baseline else args.baseline,
            passes=args.passes)
    except BaselineError as e:
        print(f"fleetlint: {e}", file=sys.stderr)
        return 2

    payload = json.dumps(report.to_dict(), indent=2, sort_keys=True)
    if args.output:
        with open(args.output, "w") as f:
            f.write(payload + "\n")
    if args.json:
        print(payload)
    else:
        print(_format_text(report))
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
