"""Pass 1 — virtual-clock purity (VCP).

The whole serving stack (router dispatch, orbit controller, obs spans,
traffic generation) runs on a *virtual* clock so seeded runs replay
bit-identically; the only sanctioned wall-clock reads are the
engine-stage timers in ``runtime/serve.py`` / ``serving/executor.py``,
which measure real device work and are re-anchored onto the virtual
timeline by the flight recorder.  This pass flags:

* ``VCP001`` — wall-clock reads: ``time.time`` / ``perf_counter`` /
  ``monotonic`` / ``process_time`` (+ ``_ns`` variants), ``time.sleep``,
  ``datetime.now`` / ``utcnow`` / ``today``.
* ``VCP002`` — nondeterministic RNG: module-global ``random.*`` calls,
  unseeded ``random.Random()`` / ``np.random.default_rng()``, legacy
  global ``np.random.<dist>`` draws, and ``np.random.seed`` (global
  state) — and torch's global generator: ``torch.manual_seed`` /
  ``torch.seed`` / ``torch.cuda.manual_seed[_all]``, the sampling
  functions ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
  ``multinomial`` / ``bernoulli`` / ``normal`` (and the ``*_like``
  draws) called without ``generator=``, and the in-place draws
  ``Tensor.uniform_`` / ``normal_`` / ``random_`` / ``exponential_``
  (and ``bernoulli_`` / ``cauchy_`` / ``geometric_`` /
  ``log_normal_``) without ``generator=``.  Seeded constructors
  (``random.Random(seed)``, ``default_rng(seed)``), an explicit
  ``torch.Generator`` passed as ``generator=``, and the port's
  counter-based ``core/prng.py`` (threefry keys) are fine.

Sanctioned sites live in ``analysis/baseline.json``, each with a reason
— so reintroducing a wall-clock read anywhere else (say,
``router/dispatch.py``) fails CI before any chaos/obs gate has the
chance to flake on it.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import FileContext, Finding, file_pass

WALL_TIME_FNS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns", "sleep",
})
DATETIME_NOW_FNS = frozenset({"now", "utcnow", "today"})
#: random-module attributes that are *not* global-RNG draws
RANDOM_NON_GLOBAL = frozenset({"Random", "SystemRandom", "getstate",
                               "setstate"})
#: torch calls that seed or reseed the process-wide generator
TORCH_GLOBAL_SEED = frozenset({"manual_seed", "seed", "manual_seed_all",
                               "initial_seed"})
#: torch sampling functions that draw from the global generator unless
#: given ``generator=``
TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm",
                         "multinomial", "bernoulli", "normal", "poisson",
                         "rand_like", "randn_like", "randint_like"})
#: in-place Tensor draws, global unless given ``generator=``
TENSOR_DRAWS = frozenset({"uniform_", "normal_", "random_", "exponential_",
                          "bernoulli_", "cauchy_", "geometric_",
                          "log_normal_"})


def _is_name(node: ast.AST, name: str) -> bool:
    return isinstance(node, ast.Name) and node.id == name


@file_pass("clock")
def clock_pass(ctx: FileContext) -> List[Finding]:
    findings: List[Finding] = []
    # track what this module calls `time` / `random` / `np` / `datetime`
    time_aliases, random_aliases, np_aliases, dt_aliases = (set(), set(),
                                                            set(), set())
    torch_aliases: set = set()
    from_time: set = set()             # `from time import perf_counter`
    from_dt: set = set()               # `from datetime import datetime`

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                alias = a.asname or a.name
                if a.name == "time":
                    time_aliases.add(alias)
                elif a.name == "random":
                    random_aliases.add(alias)
                elif a.name == "numpy":
                    np_aliases.add(alias)
                elif a.name == "datetime":
                    dt_aliases.add(alias)
                elif a.name == "torch":
                    torch_aliases.add(alias)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                from_time.update(a.asname or a.name for a in node.names
                                 if a.name in WALL_TIME_FNS)
            elif node.module == "datetime":
                from_dt.update(a.asname or a.name for a in node.names
                               if a.name in ("datetime", "date"))
            elif node.module == "numpy":
                np_aliases.update(a.asname or a.name for a in node.names
                                  if a.name == "random")

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        # time.<wall fn>()  /  bare perf_counter() from `from time import`
        if (isinstance(fn, ast.Attribute) and fn.attr in WALL_TIME_FNS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in time_aliases):
            findings.append(ctx.finding(
                "clock", "VCP001", node,
                f"wall-clock read time.{fn.attr}() — serving-stack code "
                f"runs on the virtual clock; sanctioned wall-measured "
                f"engine-stage sites belong in the baseline allowlist"))
        elif isinstance(fn, ast.Name) and fn.id in from_time:
            findings.append(ctx.finding(
                "clock", "VCP001", node,
                f"wall-clock read {fn.id}() (imported from time)"))
        # datetime.now() family: datetime.datetime.now(), datetime.now()
        elif (isinstance(fn, ast.Attribute) and fn.attr in DATETIME_NOW_FNS
              and _mentions_datetime(fn.value, dt_aliases, from_dt)):
            findings.append(ctx.finding(
                "clock", "VCP001", node,
                f"wall-clock read datetime .{fn.attr}()"))
        # random.<draw>() on the module-global RNG
        elif (isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Name)
              and fn.value.id in random_aliases
              and fn.attr not in RANDOM_NON_GLOBAL):
            findings.append(ctx.finding(
                "clock", "VCP002", node,
                f"module-global RNG random.{fn.attr}() — unseeded and "
                f"process-wide; use random.Random(seed)"))
        # random.Random() with no seed
        elif (isinstance(fn, ast.Attribute) and fn.attr == "Random"
              and isinstance(fn.value, ast.Name)
              and fn.value.id in random_aliases
              and not node.args and not node.keywords):
            findings.append(ctx.finding(
                "clock", "VCP002", node,
                "unseeded random.Random() — pass an explicit seed"))
        # np.random.*
        elif (isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Attribute)
              and fn.value.attr == "random"
              and isinstance(fn.value.value, ast.Name)
              and fn.value.value.id in np_aliases):
            if fn.attr in ("default_rng", "Generator", "RandomState"):
                if not node.args and not node.keywords:
                    findings.append(ctx.finding(
                        "clock", "VCP002", node,
                        f"unseeded np.random.{fn.attr}() — pass an "
                        f"explicit seed"))
            else:
                findings.append(ctx.finding(
                    "clock", "VCP002", node,
                    f"global-state np.random.{fn.attr}() — use "
                    f"np.random.default_rng(seed)"))
        elif isinstance(fn, ast.Attribute) and _torch_root(fn.value,
                                                           torch_aliases):
            if fn.attr in TORCH_GLOBAL_SEED:
                findings.append(ctx.finding(
                    "clock", "VCP002", node,
                    f"torch global-generator state {ast.unparse(fn)}() — "
                    f"seed an explicit torch.Generator instead"))
            elif fn.attr in TORCH_DRAWS and not _has_generator(node):
                findings.append(ctx.finding(
                    "clock", "VCP002", node,
                    f"{ast.unparse(fn)}() without generator= draws from "
                    f"torch's process-wide generator — pass a seeded "
                    f"torch.Generator (or use core/prng.py)"))
        elif (isinstance(fn, ast.Attribute) and fn.attr in TENSOR_DRAWS
              and not _has_generator(node)):
            findings.append(ctx.finding(
                "clock", "VCP002", node,
                f"in-place draw .{fn.attr}() without generator= uses "
                f"torch's process-wide generator — pass a seeded "
                f"torch.Generator"))
    return findings


def _torch_root(value: ast.AST, torch_aliases) -> bool:
    """``torch`` / ``torch.cuda`` / ``torch.random`` as the call's owner."""
    if isinstance(value, ast.Name):
        return value.id in torch_aliases
    return (isinstance(value, ast.Attribute)
            and value.attr in ("cuda", "random")
            and isinstance(value.value, ast.Name)
            and value.value.id in torch_aliases)


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def _mentions_datetime(value: ast.AST, dt_aliases, from_dt) -> bool:
    # datetime.datetime.now() -> Attribute(datetime, 'datetime').now
    if isinstance(value, ast.Attribute):
        return (value.attr in ("datetime", "date")
                and isinstance(value.value, ast.Name)
                and value.value.id in dt_aliases)
    # datetime.now() with `from datetime import datetime`
    return isinstance(value, ast.Name) and value.id in from_dt
