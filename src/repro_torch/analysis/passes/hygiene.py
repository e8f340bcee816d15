"""Pass 5a — exception-swallowing hygiene (EXC).

Drop handling on the serving hot path is *accounted*: every failed
request must land in exactly one ``drops_by_reason`` bucket, chaos
faults must surface as reason codes, and the recovery ledger asserts
exactly-once outcomes.  A broad ``except`` that swallows the exception
erases the reason code before accounting sees it.  Codes:

* ``EXC001`` — bare ``except:`` (also catches ``KeyboardInterrupt`` /
  ``SystemExit``); never acceptable.
* ``EXC002`` — broad ``except Exception`` / ``except BaseException``
  that neither re-raises nor uses the bound exception — the error is
  silently discarded.
* ``EXC003`` — any broad except on a hot-path module (``router/``,
  ``serving/``, ``obs/``, ``runtime/serve.py``, ``runtime/paging.py``,
  as in the reference, and the port's ``kernels/``, where a broad except
  around a launch would hide a failed kernel behind a plain fallback):
  these paths must catch specific exception types so reason codes stay
  precise.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import FileContext, Finding, file_pass

BROAD = frozenset({"Exception", "BaseException"})

HOT_PREFIXES = (
    "src/repro_torch/router/",
    "src/repro_torch/serving/",
    "src/repro_torch/obs/",
    "src/repro_torch/kernels/",
)
HOT_FILES = frozenset({
    "src/repro_torch/runtime/serve.py",
    "src/repro_torch/runtime/paging.py",
})


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if isinstance(t, ast.Name) and t.id in BROAD:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in BROAD
                   for e in t.elts)
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(isinstance(n, ast.Raise) for n in ast.walk(handler))


def _uses_binding(handler: ast.ExceptHandler) -> bool:
    if handler.name is None:
        return False
    return any(isinstance(n, ast.Name) and n.id == handler.name
               and isinstance(n.ctx, ast.Load)
               for n in ast.walk(handler))


@file_pass("exc")
def exc_pass(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    hot = ctx.rel in HOT_FILES or ctx.rel.startswith(HOT_PREFIXES)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            findings.append(ctx.finding(
                "exc", "EXC001", node,
                "bare `except:` — catches KeyboardInterrupt/SystemExit "
                "and erases the failure reason; name the exception types"))
            continue
        if not _is_broad(node):
            continue
        if hot:
            findings.append(ctx.finding(
                "exc", "EXC003", node,
                "broad `except Exception` on a serving hot path — drop "
                "accounting needs precise reason codes; catch the "
                "specific exception types (or route through a reason "
                "code before discarding)"))
        elif not (_reraises(node) or _uses_binding(node)):
            findings.append(ctx.finding(
                "exc", "EXC002", node,
                "broad except swallows the exception without using or "
                "re-raising it — the failure reason is lost; log it, "
                "re-raise, or narrow the type"))
    return findings
