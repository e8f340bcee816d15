#!/usr/bin/env python
"""fleetlint launcher for the PyTorch port: the repo-root entry point.

Same engine as ``python -m repro_torch.analysis`` (it bootstraps
``PYTHONPATH`` itself so it runs from a bare checkout), plus the fast
local-iteration mode:

    tools/fleetlint_torch.py                  # full port tree vs baseline
    tools/fleetlint_torch.py --diff           # only files changed vs main
    tools/fleetlint_torch.py --diff origin/x  # ... vs another ref
    tools/fleetlint_torch.py --json --output LINT_torch.json

``--diff`` lints only the changed ``src/repro_torch/*.py`` files, plus
any project pass whose subject files changed — a changed
``kernels/csrc/*.cu`` source runs the kernel-contract pass.
Stale-suppression detection is skipped on a diff slice — only the full
run can prove an entry dead.  Exit codes match the module CLI: 0 clean,
1 findings, 2 usage/baseline error.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

from repro_torch.analysis.__main__ import main as _main    # noqa: E402


def _changed_files(ref: str) -> list:
    """src/repro_torch python files and CUDA sources changed vs ``ref``
    (plus uncommitted and untracked ones)."""
    out = set()
    for args in (["git", "diff", "--name-only", ref, "--"],
                 ["git", "diff", "--name-only", "--"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(args, cwd=REPO_ROOT, capture_output=True,
                                 text=True, check=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            print(f"fleetlint: {' '.join(args)} failed: {e}",
                  file=sys.stderr)
            sys.exit(2)
        out.update(line.strip() for line in res.stdout.splitlines()
                   if line.strip())
    return sorted(p for p in out
                  if p.endswith((".py", ".cu"))
                  and p.startswith("src/repro_torch/")
                  and os.path.exists(os.path.join(REPO_ROOT, p)))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--diff" in argv:
        i = argv.index("--diff")
        argv.pop(i)
        ref = "main"
        if i < len(argv) and not argv[i].startswith("-"):
            ref = argv.pop(i)
        changed = _changed_files(ref)
        if not changed:
            print(f"fleetlint: no src/repro_torch changes vs {ref}")
            return 0
        print(f"fleetlint: linting {len(changed)} changed file(s) vs "
              f"{ref}", file=sys.stderr)
        argv = changed + argv
    return _main(argv)


if __name__ == "__main__":
    sys.exit(main())
