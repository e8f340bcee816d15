"""Pass 4 — CUDA kernel contracts (KRN), a project pass over ``kernels/``.

The port's counterpart of the reference's Pallas contract pass.  Each
wrapper in ``src/repro_torch/kernels/*.py`` reaches its kernel through
``build.entry(name, symbol, argtypes)``: ``csrc/<name>.cu`` compiled to
a shared library, its ``extern "C"`` entry ``symbol`` typed by the
hand-written ctypes ``argtypes``.  The pass reads those sites with
``ast`` (resolving argtype expressions such as ``[ctypes.c_void_p] * 8
+ [ctypes.c_int] * 8 + [ctypes.c_void_p]`` through module and local
names), the ``extern "C"`` signatures with a small C-declaration reader
(no compiler), and checks both against the table in
:mod:`repro_torch.analysis.passes.contracts`:

* ``KRN001`` — a ``build.entry`` site (or an ``extern "C"`` entry) with
  no contract;
  ``KRN002`` — a contract no ``build.entry`` site names (stale).
* ``KRN003`` — the contract's symbol is missing from its ``.cu`` (or a
  site loads it from another library).
* ``KRN004`` — the argument counts of the contract, the site and the C
  signature differ (or the site's argtypes do not resolve statically);
  ``KRN005`` — an argument's kind differs (pointer vs ``c_void_p``,
  ``int`` vs ``c_int``, ``float`` vs ``c_float``, ``long long`` /
  ``int64_t`` vs ``c_int64``).
* ``KRN006`` — the C entry does not return ``int`` (the ``cudaError_t``
  that ``build.entry`` types as ``restype``).
* ``KRN007`` — a call of the entry whose returned status never reaches
  ``build.check``: a failed launch is swallowed.
* ``KRN008`` — the wrapper has no plain route for CPU tensors, or calls
  the plain version outside a CPU-tensor guard (a fallback on a CUDA
  tensor, which would hide a kernel that does not launch).
* ``KRN009`` — a read of the block table that is not clamped by its
  dead-entry guard (see ``contracts.py``: the counterpart of the
  reference's KRN007).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (FileContext, Finding, find_def,
                                       project_pass)
from repro_torch.analysis.passes.contracts import (FLOAT, INT, INT64,
                                                   KERNEL_CONTRACTS, KERNELS,
                                                   PTR, KernelContract)

CONTRACTS_FILE = "src/repro_torch/analysis/passes/contracts.py"
CSRC_DIR = f"{KERNELS}/csrc"

CTYPES_KINDS = {"c_void_p": PTR, "c_char_p": PTR, "c_int": INT,
                "c_int32": INT, "c_float": FLOAT, "c_int64": INT64,
                "c_longlong": INT64, "c_long": INT64, "c_double": "double",
                "c_uint": "uint32", "c_uint32": "uint32",
                "c_ulonglong": "uint64", "c_uint64": "uint64"}
C_KINDS = {"int": INT, "int32_t": INT, "float": FLOAT, "long long": INT64,
           "long long int": INT64, "int64_t": INT64, "long": INT64,
           "double": "double", "unsigned": "uint32", "unsigned int": "uint32",
           "uint32_t": "uint32", "unsigned long long": "uint64",
           "uint64_t": "uint64"}
C_QUALIFIERS = {"const", "volatile", "__restrict__", "restrict"}


# ---------------------------------------------------------------------------
# the C side: extern "C" signatures, read without a compiler
# ---------------------------------------------------------------------------
def strip_comments(text: str) -> str:
    """C/C++ comments blanked out (newlines kept, so offsets map to
    lines)."""
    def blank(m: re.Match) -> str:
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


_EXTERN = re.compile(r'extern\s+"C"\s+([A-Za-z_][\w\s\*]*?)\s*\b(\w+)\s*'
                     r'\(([^)]*)\)\s*\{', re.S)


def c_kind(decl: str) -> str:
    """The kind of one C parameter declaration (its name dropped)."""
    if "*" in decl:
        return PTR
    words = [w for w in decl.split() if w not in C_QUALIFIERS]
    base = " ".join(words[:-1]) if len(words) > 1 else " ".join(words)
    return C_KINDS.get(base, base)


def extern_entries(text: str) -> Dict[str, Tuple[str, List[str], int]]:
    """``{symbol: (return type, [parameter kinds], line)}`` of every
    ``extern "C"`` definition in a CUDA source."""
    text = strip_comments(text)
    out: Dict[str, Tuple[str, List[str], int]] = {}
    for m in _EXTERN.finditer(text):
        ret = " ".join(w for w in m.group(1).split() if w not in C_QUALIFIERS)
        params = m.group(3).strip()
        kinds = ([] if params in ("", "void")
                 else [c_kind(p.strip()) for p in params.split(",")])
        out[m.group(2)] = (ret, kinds, text.count("\n", 0, m.start()) + 1)
    return out


def _close(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one opened at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def unguarded_table_reads(text: str, param: str) -> List[int]:
    """Lines of the loads through block-table pointer ``param`` (or a
    ``const int*`` taken from it) that are not the first argument of
    ``max(…, 0)``."""
    text = strip_comments(text)
    aliases = {param}
    decl = re.compile(r"const\s+int\s*\*\s*(?:__restrict__\s*)?(\w+)\s*="
                      r"\s*([^;]*);")
    grew = True
    while grew:
        grew = False
        for m in decl.finditer(text):
            if m.group(1) not in aliases and any(
                    re.search(rf"\b{re.escape(a)}\b", m.group(2))
                    for a in aliases):
                aliases.add(m.group(1))
                grew = True
    names = "|".join(re.escape(a) for a in sorted(aliases))
    bad = []
    for m in re.finditer(rf"__ldg\(\s*(?:{names})\b|\b(?:{names})\s*\[",
                         text):
        start = m.start()
        if m.group(0).startswith("__ldg"):
            end = _close(text, text.index("(", start), "(", ")")
        else:
            end = _close(text, text.index("[", start), "[", "]")
        before = text[:start].rstrip()
        after = text[end:]
        if not (before.endswith("max(")
                and re.match(r"\s*,\s*0\s*\)", after)):
            bad.append(text.count("\n", 0, start) + 1)
    return bad


# ---------------------------------------------------------------------------
# the python side: build.entry sites
# ---------------------------------------------------------------------------
class _Site:
    """One ``build.entry(name, symbol, argtypes)`` call."""

    def __init__(self, ctx: FileContext, call: ast.Call, fn: ast.AST,
                 env: Dict[str, ast.AST]):
        self.ctx, self.call, self.fn = ctx, call, fn
        self.symbol_scope = ctx.symbol(call)
        local = dict(env)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                _bind(local, node)
        args = list(call.args) + [None] * 3
        self.library = (args[0].value if isinstance(args[0], ast.Constant)
                        else None)
        self.symbols = _symbols(args[1], local)
        self.kinds = _kinds(args[2], local) if args[2] is not None else None


def _bind(env: Dict[str, ast.AST], node: ast.Assign) -> None:
    for tgt in node.targets:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = node.value
        elif (isinstance(tgt, (ast.Tuple, ast.List))
              and isinstance(node.value, (ast.Tuple, ast.List))
              and len(tgt.elts) == len(node.value.elts)):
            for t, v in zip(tgt.elts, node.value.elts):
                if isinstance(t, ast.Name):
                    env[t.id] = v


def _symbols(node: Optional[ast.AST], env) -> Set[str]:
    """The symbol(s) a site's second argument can name: a string, a
    name bound to one, or a subscript of a dict of them."""
    if node is None:
        return set()
    if isinstance(node, ast.Name) and node.id in env:
        return _symbols(env[node.id], env)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.Subscript):
        table = node.value
        if isinstance(table, ast.Name) and table.id in env:
            table = env[table.id]
        if isinstance(table, ast.Dict):
            return {v.value for v in table.values
                    if isinstance(v, ast.Constant)
                    and isinstance(v.value, str)}
    return set()


def _kinds(node: ast.AST, env, depth: int = 0) -> Optional[List[str]]:
    """Argument kinds of an argtypes expression, or None if it does not
    resolve statically."""
    if depth > 20:
        return None
    if isinstance(node, ast.Name):
        return (_kinds(env[node.id], env, depth + 1) if node.id in env
                else None)
    if isinstance(node, ast.Attribute):
        kind = CTYPES_KINDS.get(node.attr)
        return [kind] if kind is not None else None
    if isinstance(node, (ast.List, ast.Tuple)):
        out: List[str] = []
        for el in node.elts:
            k = _kinds(el, env, depth + 1)
            if k is None:
                return None
            out.extend(k)
        return out
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("list", "tuple") and len(node.args) == 1:
        return _kinds(node.args[0], env, depth + 1)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            a, b = (_kinds(node.left, env, depth + 1),
                    _kinds(node.right, env, depth + 1))
            return None if a is None or b is None else a + b
        if isinstance(node.op, ast.Mult):
            for seq, n in ((node.left, node.right), (node.right, node.left)):
                if isinstance(n, ast.Constant) and isinstance(n.value, int):
                    k = _kinds(seq, env, depth + 1)
                    return None if k is None else k * n.value
    return None


def _is_build_attr(node: ast.AST, attr: str, build_names: Set[str]) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and isinstance(node.value, ast.Name)
            and node.value.id in build_names)


def _build_names(tree: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names
                         if a.name == "build")
        elif isinstance(node, ast.Import):
            names.update(a.asname for a in node.names
                         if a.name.endswith(".build") and a.asname)
    return names


def _unchecked_calls(site: _Site, build_names: Set[str]) -> List[ast.Call]:
    """Calls of the entry whose status never reaches ``build.check``."""
    fn = site.fn
    bound: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and node.value is site.call:
            bound.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    checked_args: List[ast.AST] = [
        n.args[0] for n in ast.walk(fn)
        if isinstance(n, ast.Call) and _is_build_attr(n.func, "check",
                                                      build_names)
        and n.args]
    status_names: Dict[str, ast.Call] = {}
    launches: List[ast.Call] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and (
                node.func is site.call
                or (isinstance(node.func, ast.Name)
                    and node.func.id in bound)):
            launches.append(node)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and node.value in launches:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    status_names[t.id] = node.value
    bad = []
    for call in launches:
        direct = any(arg is call for arg in checked_args)
        via = [n for n, c in status_names.items() if c is call]
        reached = any(isinstance(x, ast.Name) and x.id in via
                      for arg in checked_args for x in ast.walk(arg))
        if not (direct or reached):
            bad.append(call)
    return bad


# ---------------------------------------------------------------------------
# KRN008: the plain route
# ---------------------------------------------------------------------------
def _device_test(test: ast.AST) -> Optional[bool]:
    """True if ``test`` holds for CUDA tensors only, False if for CPU
    tensors only, None if it is not a device test."""
    neg = False
    while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        neg, test = not neg, test.operand
    res: Optional[bool] = None
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        res = True
    elif (isinstance(test, ast.Compare) and len(test.ops) == 1
          and isinstance(test.left, ast.Attribute)
          and test.left.attr == "type"
          and isinstance(test.comparators[0], ast.Constant)
          and test.comparators[0].value in ("cpu", "cuda")):
        res = test.comparators[0].value == "cuda"
        if isinstance(test.ops[0], ast.NotEq):
            res = not res
        elif not isinstance(test.ops[0], ast.Eq):
            return None
    if res is None:
        return None
    return not res if neg else res


def plain_calls(fn: ast.AST, plain: str) -> List[Tuple[ast.Call, bool]]:
    """Every call of ``plain`` in ``fn`` with whether it sits under a
    CPU-tensor guard (and outside any ``except`` handler)."""
    out: List[Tuple[ast.Call, bool]] = []

    def visit(node: ast.AST, cpu: bool) -> None:
        if isinstance(node, ast.If):
            dev = _device_test(node.test)
            visit(node.test, cpu)
            for stmt in node.body:
                visit(stmt, cpu or dev is False)
            for stmt in node.orelse:
                visit(stmt, cpu or dev is True)
            return
        if isinstance(node, ast.ExceptHandler):
            for child in ast.iter_child_nodes(node):
                visit(child, False)       # a fallback on failure
            return
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == plain):
            out.append((node, cpu))
        for child in ast.iter_child_nodes(node):
            visit(child, cpu)

    for stmt in fn.body:
        visit(stmt, False)
    return out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------
def _read(root: str, rel: str) -> Optional[str]:
    p = os.path.join(root, *rel.split("/"))
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return f.read()


@project_pass("kernel")
def kernel_pass(root: str) -> List[Finding]:
    findings: List[Finding] = []
    base = os.path.join(root, *KERNELS.split("/"))
    if not os.path.isdir(base):
        return findings

    def finding(code: str, path: str, line: int, msg: str,
                symbol: str) -> None:
        findings.append(Finding("kernel", code, path, line, msg,
                                symbol=symbol))

    # ---- every build.entry site ----------------------------------------
    sites: Dict[str, List[_Site]] = {}
    trees: Dict[str, FileContext] = {}
    for fname in sorted(os.listdir(base)):
        if not fname.endswith(".py"):
            continue
        rel = f"{KERNELS}/{fname}"
        try:
            ctx = FileContext(root, rel, _read(root, rel))
        except SyntaxError:
            continue        # run_lint's file passes report it as a parse error
        trees[rel] = ctx
        build_names = _build_names(ctx.tree) or {"build"}
        env: Dict[str, ast.AST] = {}
        for node in ctx.tree.body:
            if isinstance(node, ast.Assign):
                _bind(env, node)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and _is_build_attr(call.func, "entry", build_names)):
                    continue
                if ctx.symbol(call) != ".".join(
                        p for p in (ctx.symbol(fn), fn.name) if p):
                    continue              # owned by a nested def
                site = _Site(ctx, call, fn, env)
                where = site.symbol_scope
                if not site.symbols:
                    finding("KRN001", rel, call.lineno,
                            "build.entry site whose symbol does not resolve "
                            "statically — name the entry with a string (or "
                            "a dict of strings)", where)
                for sym in sorted(site.symbols):
                    sites.setdefault(sym, []).append(site)
                    if sym not in KERNEL_CONTRACTS:
                        finding("KRN001", rel, call.lineno,
                                f"build.entry of {sym!r} has no entry in "
                                f"analysis/passes/contracts.py — every "
                                f"kernel entry needs a declared contract",
                                where)
                for bad in _unchecked_calls(site, build_names):
                    finding("KRN007", rel, bad.lineno,
                            f"the status of {'/'.join(sorted(site.symbols))}"
                            f" is not passed to build.check — a failed "
                            f"launch would be swallowed", where)

    # ---- every extern "C" entry ----------------------------------------
    externs: Dict[str, Dict[str, Tuple[str, List[str], int]]] = {}
    csrc = os.path.join(root, *CSRC_DIR.split("/"))
    if os.path.isdir(csrc):
        for fname in sorted(os.listdir(csrc)):
            if fname.endswith(".cu"):
                rel = f"{CSRC_DIR}/{fname}"
                externs[rel] = extern_entries(_read(root, rel))
                for sym, (_, _, line) in externs[rel].items():
                    if sym not in KERNEL_CONTRACTS:
                        finding("KRN001", rel, line,
                                f'extern "C" entry {sym!r} has no contract '
                                f"in analysis/passes/contracts.py", sym)

    # ---- each contract against its site and its signature -------------
    for sym, c in sorted(KERNEL_CONTRACTS.items()):
        findings.extend(_check_contract(root, sym, c, sites.get(sym, []),
                                        externs, trees))
    return findings


def _check_contract(root: str, sym: str, c: KernelContract,
                    sites: List[_Site], externs, trees) -> List[Finding]:
    out: List[Finding] = []

    def flag(code: str, path: str, line: int, msg: str) -> None:
        out.append(Finding("kernel", code, path, line, msg, symbol=sym))

    want = list(c.argtypes)
    if not sites:
        flag("KRN002", CONTRACTS_FILE, 0,
             f"stale kernel contract {sym!r}: no build.entry site under "
             f"{KERNELS} names it")
    stem = c.source.rsplit("/", 1)[-1][:-3]
    for s in sites:
        rel, line = s.ctx.rel, s.call.lineno
        if rel != c.module:
            flag("KRN003", rel, line,
                 f"{sym!r} is entered from {rel}, its contract says "
                 f"{c.module}")
        if s.library != stem:
            flag("KRN003", rel, line,
                 f"build.entry loads {sym!r} from library {s.library!r}; "
                 f"it is defined in {c.source}")
        if s.kinds is None:
            flag("KRN004", rel, line,
                 f"argtypes of {sym!r} do not resolve statically — write "
                 f"them from ctypes names, lists, + and * n")
        else:
            out.extend(_compare(sym, "build.entry argtypes", s.kinds,
                                "the contract", want, rel, line))
    entry = externs.get(c.source, {}).get(sym)
    if entry is None:
        flag("KRN003", c.source, 0,
             f'{sym!r} is not an extern "C" entry of {c.source}'
             + ("" if c.source in externs else " (no such source)"))
    else:
        ret, kinds, line = entry
        if ret != "int":
            flag("KRN006", c.source, line,
                 f"{sym} returns {ret!r}: build.entry types every entry's "
                 f"restype as c_int (a cudaError_t)")
        out.extend(_compare(sym, f'the extern "C" signature', kinds,
                            "the contract", want, c.source, line))
        if c.dead_entry_guard:
            for bad in unguarded_table_reads(_read(root, c.source),
                                             c.dead_entry_guard):
                flag("KRN009", c.source, bad,
                     f"{c.source} reads the block table "
                     f"({c.dead_entry_guard}) without max(..., 0) — a -1 "
                     f"dead entry would address out of bounds")
    # ---- the plain route ----------------------------------------------
    ctx = trees.get(c.module)
    if ctx is not None and c.plain is not None:
        fn = find_def(ctx.tree, c.wrapper)
        if fn is None:
            flag("KRN008", c.module, 0,
                 f"wrapper {c.wrapper} of {sym!r} not found in {c.module}")
        else:
            calls = plain_calls(fn, c.plain)
            if not any(cpu for _, cpu in calls):
                flag("KRN008", c.module, fn.lineno,
                     f"{c.wrapper} has no plain route ({c.plain}) for CPU "
                     f"tensors")
            for call, cpu in calls:
                if not cpu:
                    flag("KRN008", c.module, call.lineno,
                         f"{c.wrapper} calls {c.plain} outside a CPU-tensor "
                         f"guard — a CUDA tensor would fall back to the "
                         f"plain version instead of launching (or "
                         f"raising)")
    return out


def _compare(sym: str, what: str, got: List[str], against: str,
             want: List[str], path: str, line: int) -> List[Finding]:
    if len(got) != len(want):
        return [Finding("kernel", "KRN004", path, line,
                        f"{what} of {sym!r} has {len(got)} arguments, "
                        f"{against} {len(want)}", symbol=sym)]
    return [Finding("kernel", "KRN005", path, line,
                    f"{what} of {sym!r}: argument {i} is {g!r}, {against} "
                    f"says {w!r}", symbol=sym)
            for i, (g, w) in enumerate(zip(got, want)) if g != w]
