"""Pass 2 — host syncs inside device programs (SYN).

The counterpart of the reference's jit-boundary pass (``jitcheck.py``,
JIT001-5).  The port has no ``jit``: its device work is eager torch, and
what goes wrong is a host sync in the middle of it.  A ``.item()`` or a
``bool(tensor)`` inside a decode step waits for the stream to drain
(the host can no longer run ahead of the card), and it breaks CUDA-graph
capture of the step (ROADMAP queue 1 item 4 wants the decode step in
one graph).  The pass cannot find device work by a decorator, so the
table ``DEVICE_PROGRAMS`` below names the functions whose bodies are
device programs — one entry per counterpart of a reference jitted
context.  Where the port's device work sits inline in a host method
(``ContinuousBatchingEngine._decode_once``), the table names the
callees that hold it; the host method's one read of the step's outputs
is the counterpart of reading a jitted result, and is not flagged.

Inside a listed body (nested defs and lambdas included) it flags:

* ``SYN001`` — ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``,
  or ``bool()`` / ``int()`` / ``float()`` of an expression mentioning a
  tensor value.
* ``SYN002`` — a host ``numpy`` call on tensor data (an argument
  mentions a tensor value); numpy on shape-derived host values is
  fine.
* ``SYN003`` — Python ``if`` / ``while`` whose test mentions a tensor
  value.  Names derived from ``.shape`` / ``.ndim`` / ``.dtype``
  are static and exempt (as in JIT003), and so are ``is None`` /
  ``is not None`` tests, ``"key" in params`` tests and ``isinstance``
  checks (no read of the data).
* ``SYN004`` — ``torch.cuda.synchronize()`` (or a stream's / event's
  ``.synchronize()``) or a ``.to("cpu")``.
* ``SYN005`` — a tensor built from a Python list or a pageable host
  array: ``torch.tensor(...)`` (but for a shape-derived scalar, which
  a CUDA op takes as an immediate), ``torch.from_numpy(...)``, or
  ``torch.as_tensor`` of a list literal or of ``np.…`` (a blocking
  host-to-device copy on every call; ROADMAP "Device copies").
* ``SYN006`` — a table entry whose function no longer exists (stale):
  the table must follow renames, or the pass silently stops checking.

Tensor parameters are every parameter but ``self`` / ``cls`` and the
entry's ``host_args`` (configs, plans, Python flags and ints — the
counterpart of ``static_argnames``).  A local assigned (or looped over)
from an expression that mentions a tensor, and that is not
shape-derived, is a tensor too: in eager torch it lives on the device
(``nxt = logits.argmax(-1); if (nxt == eos).any():`` is a sync).
``assert`` statements are exempt.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.core import (FileContext, Finding, file_pass,
                                       find_def, project_pass)

SERVE = "src/repro_torch/runtime/serve.py"
PAGING = "src/repro_torch/runtime/paging.py"
MODEL = "src/repro_torch/models/transformer.py"
REF_SERVE = "src/repro/runtime/serve.py"
REF_PAGING = "src/repro/runtime/paging.py"
_MODEL_HOST = ("cfg", "plan", "tp")
_DECODES = tuple(f"{REF_SERVE}::ContinuousBatchingEngine.__init__.{n}"
                 for n in ("_decode_greedy", "_decode_sampled",
                           "_decode_greedy_h", "_decode_sampled_h"))
_WINDOWED = (f"{REF_SERVE}::WindowedBaselineServer.__init__.<lambda>",)
_ADMIT = f"{REF_SERVE}::ContinuousBatchingEngine._admit_impl"
_CHUNK = f"{REF_SERVE}::ContinuousBatchingEngine._chunk_impl"


@dataclass(frozen=True)
class DeviceProgram:
    """One function whose body is device work."""
    path: str                       # repo-relative module
    qualname: str                   # def, Class.method or outer.inner
    host_args: Tuple[str, ...] = ()  # parameters that are host values
    ref: Tuple[str, ...] = ()       # reference jitted contexts it stands for


DEVICE_PROGRAMS: Tuple[DeviceProgram, ...] = (
    # the engine: admission, chunked prefill, decode and the hardening sums
    DeviceProgram(SERVE, "_gather_block_rows",
                  ref=(f"{REF_SERVE}::_gather_block_rows",)),
    DeviceProgram(SERVE, "_paste_block_rows",
                  ref=(f"{REF_SERVE}::_paste_block_rows",)),
    DeviceProgram(SERVE, "ContinuousBatchingEngine._pick",
                  host_args=("sampled",),
                  ref=(_ADMIT, _CHUNK) + _DECODES),
    # toks / admit arrive as host arrays: their one copy to the card is
    # the counterpart of the jitted call's argument transfer
    DeviceProgram(SERVE, "ContinuousBatchingEngine._prefill_paste",
                  host_args=("toks", "admit"), ref=(_ADMIT,)),
    DeviceProgram(SERVE, "ContinuousBatchingEngine._checksum",
                  ref=(f"{REF_SERVE}::ContinuousBatchingEngine.__init__."
                       f"_cache_checksums",) + _DECODES[2:]),
    DeviceProgram(MODEL, "decode_step", host_args=_MODEL_HOST,
                  ref=_DECODES + _WINDOWED),
    DeviceProgram(MODEL, "prefill", host_args=_MODEL_HOST,
                  ref=(_ADMIT,) + _WINDOWED),
    DeviceProgram(MODEL, "prefill_paged_chunk",
                  host_args=_MODEL_HOST + ("seq", "start"), ref=(_CHUNK,)),
    # what those three call: the stack, its attention, the sampler
    DeviceProgram(MODEL, "forward",
                  host_args=_MODEL_HOST + ("decode", "chunk"),
                  ref=(_ADMIT, _CHUNK) + _DECODES + _WINDOWED),
    DeviceProgram("src/repro_torch/models/attention.py", "attention_apply",
                  host_args=("cfg", "policy", "chunked")),
    DeviceProgram("src/repro_torch/runtime/sampling.py", "sample_logits",
                  ref=(_ADMIT, _CHUNK, _DECODES[1], _DECODES[3])),
    # the paged KV writes and the pool checksums
    DeviceProgram(PAGING, "append_tokens",
                  ref=(f"{REF_PAGING}::append_tokens",)),
    DeviceProgram(PAGING, "write_prefill", host_args=("seq",),
                  ref=(f"{REF_PAGING}::write_prefill",)),
    DeviceProgram(PAGING, "write_prefill_batch",
                  ref=(f"{REF_PAGING}::write_prefill_batch",)),
    DeviceProgram(PAGING, "write_prefill_chunk", host_args=("seq", "start"),
                  ref=(f"{REF_PAGING}::write_prefill_chunk",)),
    DeviceProgram(PAGING, "pool_checksums"),
    # the XLA-side attention walks and their port counterparts
    DeviceProgram("src/repro_torch/kernels/ops.py", "paged_chunk_attention",
                  ref=("src/repro/kernels/ops.py::"
                       "paged_chunk_attention_xla",)),
    DeviceProgram("src/repro_torch/kernels/paged_attention.py",
                  "paged_attention_plain",
                  ref=("src/repro/kernels/ops.py::paged_attention_xla",)),
    # the staged server's decode microbatch
    DeviceProgram("src/repro_torch/serving/stage_executor.py",
                  "StageAxisEngine._decode",
                  ref=("src/repro/serving/stage_executor.py::"
                       "StageAxisEngine._decode_impl",)),
    # training: the LM step and its gradient, the state init, UrsoNet
    DeviceProgram("src/repro_torch/runtime/train_loop.py",
                  "make_step_fn.step"),
    DeviceProgram("src/repro_torch/runtime/train_loop.py",
                  "make_grad_fn.grads_of"),
    DeviceProgram("src/repro_torch/runtime/train_loop.py",
                  "Trainer._init_state", host_args=("device",),
                  ref=("src/repro/runtime/train_loop.py::Trainer.__init__."
                       "<lambda>",)),
    DeviceProgram("src/repro_torch/pose.py", "train_step",
                  host_args=("cfg", "policies", "tc"),
                  ref=("src/repro/pose.py::train_ursonet.step",)),
    DeviceProgram("src/repro_torch/models/cnn.py", "ursonet_apply",
                  host_args=("cfg", "backbone_policy", "head_policy"),
                  ref=("src/repro/pose.py::eval_ursonet.<lambda>",)),
)

#: reference jitted contexts with no DEVICE_PROGRAMS entry, and why
NO_DEVICE_PROGRAM: Dict[str, str] = {
    **{f"src/repro/kernels/{mod}.py::{fn}": (
        "a Pallas wrapper: its port counterpart is a hand-written CUDA "
        "kernel behind a ctypes entry, held by the kernel pass's "
        "contract table (passes/contracts.py)")
       for mod, fn in (("paged_attention", "paged_attention_pallas"),
                       ("flash_attention", "flash_attention_pallas"),
                       ("int8_matmul", "int8_matmul_pallas"),
                       ("quant", "rowwise_quant_pallas"),
                       ("selective_scan", "selective_scan_pallas"),
                       ("wkv", "wkv_pallas"))},
    **{f"src/repro/launch/dryrun.py::lower_cell.{fn}": (
        "the port's dry run traces the cell under FakeTensorMode "
        "(launch/dryrun.py): nothing runs on a device, so no host sync "
        "can stall one")
       for fn in ("prefill_fn", "decode_fn")},
}

SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
HOST_CASTS = frozenset({"bool", "int", "float"})
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "itemsize",
                          "device", "is_cuda"})


def _aliases(tree: ast.AST, module: str) -> Set[str]:
    """The names ``import <module> [as x]`` binds in this file."""
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.Import) for a in node.names
            if a.name == module}


def _params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg is not None:
        names.append(a.vararg.arg)
    if a.kwarg is not None:
        names.append(a.kwarg.arg)
    return names


def _target_names(tgt: ast.AST) -> List[str]:
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [n for el in tgt.elts for n in _target_names(el)]
    if isinstance(tgt, ast.Starred):
        return _target_names(tgt.value)
    return []


def _is_static_expr(expr: ast.AST, static: Set[str]) -> bool:
    """Conservatively true when ``expr`` is shape/constant-derived."""
    if isinstance(expr, ast.Constant):
        return True
    if isinstance(expr, ast.Name):
        return expr.id in static
    if isinstance(expr, ast.Attribute):
        return expr.attr in STATIC_ATTRS
    if isinstance(expr, ast.Subscript):
        return _is_static_expr(expr.value, static)
    if isinstance(expr, ast.BinOp):
        return (_is_static_expr(expr.left, static)
                and _is_static_expr(expr.right, static))
    if isinstance(expr, ast.UnaryOp):
        return _is_static_expr(expr.operand, static)
    if isinstance(expr, ast.Tuple):
        return all(_is_static_expr(e, static) for e in expr.elts)
    if isinstance(expr, ast.Call):
        f = expr.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if name in ("len", "min", "max", "sqrt", "ceil", "floor", "abs",
                    "round", "int", "float", "size", "dim", "numel"):
            if isinstance(f, ast.Attribute) and name in ("size", "dim",
                                                         "numel"):
                return True              # x.size(i) / x.dim(): metadata
            return all(_is_static_expr(a, static) for a in expr.args)
    return False


def _loop_bindings(target: ast.AST, it: ast.AST):
    """``(host names, [(targets, value)])`` a loop binds: the index of
    ``enumerate(x)`` and the keys of ``d.items()`` / ``d.keys()`` are host
    values; the rest takes after what it iterates over."""
    call = it if isinstance(it, ast.Call) else None
    name = (call.func.id if call and isinstance(call.func, ast.Name)
            else call.func.attr if call
            and isinstance(call.func, ast.Attribute) else None)
    pair = isinstance(target, ast.Tuple) and len(target.elts) == 2
    if name == "enumerate" and pair and call.args:
        return _target_names(target.elts[0]), [([target.elts[1]],
                                                call.args[0])]
    if name == "items" and pair:
        return _target_names(target.elts[0]), [([target.elts[1]], it)]
    if name == "keys":
        return _target_names(target), []
    return [], [([target], it)]


def _is_type_check(node: ast.AST) -> bool:
    """``isinstance(...)``, or ``any``/``all`` over a generator of them."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
        return False
    if node.func.id == "isinstance":
        return True
    return (node.func.id in ("any", "all") and len(node.args) == 1
            and isinstance(node.args[0], ast.GeneratorExp)
            and _is_type_check(node.args[0].elt))


def _strip_identity(test: ast.AST) -> ast.AST:
    """Drop ``x is None`` / ``x is not None`` terms, ``"key" in d`` tests
    and type checks (no read of the data); returns None when nothing else
    is left."""
    if (isinstance(test, ast.Compare) and len(test.ops) == 1
            and (isinstance(test.ops[0], (ast.Is, ast.IsNot))
                 or (isinstance(test.ops[0], (ast.In, ast.NotIn))
                     and isinstance(test.left, ast.Constant)
                     and isinstance(test.left.value, str)))) \
            or _is_type_check(test):
        return None
    if isinstance(test, ast.BoolOp):
        rest = [v for v in (_strip_identity(v) for v in test.values)
                if v is not None]
        if not rest:
            return None
        return rest[0] if len(rest) == 1 else ast.BoolOp(test.op, rest)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _strip_identity(test.operand)
        return None if inner is None else test
    return test


def _only_metadata(test: ast.AST, tensors: Set[str]) -> bool:
    """Every mention of a tensor name in ``test`` reads only metadata
    (``x.shape``, ``x.ndim``, ``x.dtype``, ``x.size(…)``, ``len(x)``)."""
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(test):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in tensors:
            up = parents.get(id(node))
            if isinstance(up, ast.Attribute) and up.attr in STATIC_ATTRS:
                continue
            if (isinstance(up, ast.Attribute)
                    and up.attr in ("size", "dim", "numel")):
                continue
            if (isinstance(up, ast.Call) and isinstance(up.func, ast.Name)
                    and up.func.id == "len"):
                continue
            return False
    return True


def _check_body(ctx: FileContext, entry: DeviceProgram, fn: ast.AST,
                np_names: Set[str], torch_names: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    host = set(entry.host_args) | {"self", "cls"}
    tensors = {p for p in _params(fn) if p not in host}

    # names derived from shapes/dtypes are static: iterate to fixpoint
    static: Set[str] = set(host)
    assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
    for _ in range(4):
        grew = False
        for a in assigns:
            if _is_static_expr(a.value, static):
                for tgt in a.targets:
                    for name in _target_names(tgt):
                        if name not in static:
                            static.add(name)
                            grew = True
        if not grew:
            break

    def mentions_tensor(expr: ast.AST) -> bool:
        return any(isinstance(n, ast.Name) and n.id in tensors
                   for n in ast.walk(expr))

    # a local computed from a tensor is a tensor too (eager torch: it
    # lives on the device): iterate to fixpoint, static names excepted
    derived = [(a.targets, a.value) for a in assigns] + [
        ([n.target], n.value) for n in ast.walk(fn)
        if isinstance(n, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr))
        and n.value is not None]
    for n in ast.walk(fn):
        if isinstance(n, (ast.For, ast.comprehension)):
            keys, values = _loop_bindings(n.target, n.iter)
            static.update(keys)
            derived += values
    tensors -= static
    while True:
        grew = {name for targets, value in derived
                if not _is_static_expr(value, static)
                and mentions_tensor(value)
                for tgt in targets for name in _target_names(tgt)
                } - tensors - static
        if not grew:
            break
        tensors |= grew

    def flag(code: str, node: ast.AST, msg: str) -> None:
        findings.append(ctx.finding("hostsync", code, node,
                                    f"{msg} inside device program "
                                    f"{entry.qualname}"))

    body = [n for stmt in fn.body for n in ast.walk(stmt)]
    for node in body:
        if isinstance(node, ast.Assert):
            continue
        if isinstance(node, (ast.If, ast.While)):
            test = _strip_identity(node.test)
            if test is None or not mentions_tensor(test) \
                    or _only_metadata(test, tensors):
                continue
            kind = "while" if isinstance(node, ast.While) else "if"
            flag("SYN003", node,
                 f"Python `{kind}` on a tensor value — reads the data back "
                 f"to the host (a stream sync); use torch.where or keep "
                 f"the decision on the host side")
        elif isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Name) and f.id in HOST_CASTS
                    and node.args and mentions_tensor(node.args[0])
                    and not _only_metadata(node.args[0], tensors)):
                flag("SYN001", node,
                     f"host conversion {f.id}() of a tensor value — "
                     f"implicit device sync")
            elif isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                flag("SYN001", node,
                     f".{f.attr}() — copies to the host and waits for the "
                     f"stream on every call")
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                flag("SYN004", node,
                     f"{ast.unparse(f)}() — blocks the host on the device")
            elif (isinstance(f, ast.Attribute) and f.attr == "to"
                  and _to_cpu(node)):
                flag("SYN004", node,
                     ".to(\"cpu\") — a blocking device-to-host copy")
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Name)
                  and f.value.id in torch_names
                  and _host_built(f.attr, node, np_names, static)):
                flag("SYN005", node,
                     f"torch.{f.attr}() of a host list or array — a "
                     f"pageable host-to-device copy on every call; build "
                     f"it once outside, or on the device")
            elif (_root_name(f) in np_names
                  and any(mentions_tensor(a) for a in
                          list(node.args) + [k.value for k in node.keywords])):
                flag("SYN002", node,
                     f"host numpy {ast.unparse(f)}() on tensor data — runs "
                     f"on the CPU and pulls the data across; use torch on "
                     f"the tensor's device")
    return findings


def _root_name(node: ast.AST):
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _to_cpu(call: ast.Call) -> bool:
    args = list(call.args) + [k.value for k in call.keywords
                              if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                and a.value.split(":")[0] == "cpu":
            return True
        if (isinstance(a, ast.Call) and a.args
                and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True                    # torch.device("cpu")
    return False


def _host_built(attr: str, call: ast.Call, np_names: Set[str],
                static: Set[str]) -> bool:
    if attr == "from_numpy":
        return True
    if attr == "tensor":
        return not (call.args and _is_static_expr(call.args[0], static))
    if attr == "as_tensor" and call.args:
        src = call.args[0]
        if isinstance(src, (ast.List, ast.Tuple, ast.ListComp)):
            return True
        return any(isinstance(n, ast.Name) and n.id in np_names
                   for n in ast.walk(src))
    return False


@file_pass("hostsync")
def hostsync_pass(ctx: FileContext) -> List[Finding]:
    entries = [e for e in DEVICE_PROGRAMS if e.path == ctx.rel]
    if not entries:
        return []
    np_names = _aliases(ctx.tree, "numpy")
    torch_names = _aliases(ctx.tree, "torch")
    findings: List[Finding] = []
    for entry in entries:
        fn = find_def(ctx.tree, entry.qualname)
        if fn is None:
            findings.append(Finding(
                "hostsync", "SYN006", ctx.rel, 0,
                f"stale DEVICE_PROGRAMS entry {entry.qualname!r}: no such "
                f"function in {ctx.rel} — follow the rename in "
                f"analysis/passes/hostsync.py", symbol=entry.qualname))
            continue
        findings.extend(_check_body(ctx, entry, fn, np_names, torch_names))
    return findings


@project_pass("hostsync")
def hostsync_modules_pass(root: str) -> List[Finding]:
    """SYN006 for table entries whose module is gone (a file pass never
    sees a missing file)."""
    return [Finding("hostsync", "SYN006", e.path, 0,
                    f"stale DEVICE_PROGRAMS entry {e.qualname!r}: "
                    f"{e.path} does not exist", symbol=e.qualname)
            for e in DEVICE_PROGRAMS
            if not os.path.exists(os.path.join(root, *e.path.split("/")))]


def covered_reference_contexts() -> Set[str]:
    """Every reference jitted context some entry stands for."""
    return {r for e in DEVICE_PROGRAMS for r in e.ref}
