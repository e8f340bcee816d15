"""Pass 3 — allocator-accounting encapsulation (ALC).

``tests/test_paging.py`` property-tests the books (and
``tests/test_torch_paging.py`` holds the port's to them):
``available + live + quarantined == num_blocks`` for
:class:`BlockAllocator`, refcount/digest agreement for
:class:`SharedBlockIndex`, digest-window bounds for
:class:`BlockDigestStore`.  Those proofs only hold if *every* mutation
goes through the sanctioned methods (``alloc`` / ``release`` /
``quarantine`` / ``acquire`` / ``register`` / ``seal`` / ``forget`` /
``purge`` ...).  This pass flags direct writes to the accounting state
from outside ``runtime/paging.py``:

* ``ALC001`` — mutation of a protected attribute (assignment,
  aug-assign, ``del``, or a mutating method call such as ``.append`` /
  ``.pop`` / ``.add`` / ``.clear``) on ``.free`` / ``.quarantined``
  (when the owner looks like an allocator) or on the always-private
  ``._sums`` / ``._cursor`` / ``._refs`` / ``._by_digest`` /
  ``._digest_of`` anywhere.

Reads are fine — ``len(self.alloc.quarantined)`` is how the scrubber
sizes its work queue.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import FileContext, Finding, file_pass

#: attributes private to paging.py no matter what object holds them
ALWAYS_PROTECTED = frozenset({"_sums", "_cursor", "_refs", "_by_digest",
                              "_digest_of"})
#: generic names — protected only when the owner expression smells like
#: an allocator (``alloc`` somewhere in its dotted path), to avoid
#: flagging unrelated ``.free`` attributes
ALLOCATOR_ATTRS = frozenset({"free", "quarantined"})

MUTATING_METHODS = frozenset({
    "append", "appendleft", "pop", "popleft", "remove", "add", "discard",
    "clear", "update", "insert", "extend", "setdefault", "sort",
    "reverse",
})

#: the one module allowed to touch the books directly
HOME = "src/repro_torch/runtime/paging.py"


def _owner_mentions_alloc(node: ast.AST) -> bool:
    """True if the dotted owner path contains an allocator-ish name."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return any("alloc" in p.lower() for p in parts)


def _is_protected(attr: ast.Attribute) -> bool:
    if attr.attr in ALWAYS_PROTECTED:
        return True
    if attr.attr in ALLOCATOR_ATTRS and _owner_mentions_alloc(attr.value):
        return True
    return False


@file_pass("alloc")
def alloc_pass(ctx: FileContext) -> List[Finding]:
    if ctx.rel == HOME:
        return []
    findings: List[Finding] = []

    def flag(node: ast.AST, attr: str, how: str) -> None:
        findings.append(ctx.finding(
            "alloc", "ALC001", node,
            f"direct {how} of allocator accounting state .{attr} outside "
            f"runtime/paging.py — bypasses the property-tested books "
            f"(available + live + quarantined == num_blocks); use the "
            f"sanctioned allocator/index methods"))

    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                # x.free = [...]  /  x._refs[k] += 1
                base = tgt
                if isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, ast.Attribute) and _is_protected(base):
                    flag(node, base.attr, "write")
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                base = tgt
                if isinstance(base, ast.Subscript):
                    base = base.value
                if isinstance(base, ast.Attribute) and _is_protected(base):
                    flag(node, base.attr, "delete")
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in MUTATING_METHODS
                    and isinstance(fn.value, ast.Attribute)
                    and _is_protected(fn.value)):
                flag(node, fn.value.attr, f"mutation (.{fn.attr}())")
    return findings
