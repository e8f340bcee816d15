"""Declarative contracts for every CUDA kernel entry in ``kernels/csrc``.

One entry per ``extern "C"`` entry of ``src/repro_torch/kernels/csrc/
*.cu``: the port's counterpart of the reference's table of Pallas
contracts (``src/repro/analysis/passes/contracts.py``).  A wrapper in
``kernels/*.py`` reaches a kernel through ``build.entry(name, symbol,
argtypes)``, a ctypes pointer typed by hand; nothing at run time holds
those argtypes to the C signature, and a wrong count or kind there is
memory corruption on the card, not an error.  The kernel pass
(``passes/kernels.py``) checks, without compiling anything, that each
contract, its ``build.entry`` site and the C signature agree (count and
kind of every argument, the ``int`` status), that the status reaches
``build.check``, and that the wrapper takes the plain version on CPU
tensors and never on CUDA ones.  A kernel entry without a contract (or a
contract left behind) is itself a finding, so this table stays the
single inventory of the port's device code.

Argument kinds: ``PTR`` (a C pointer, ``ctypes.c_void_p``), ``INT``
(``int``, ``ctypes.c_int``), ``FLOAT`` (``float``, ``ctypes.c_float``),
``INT64`` (``long long`` / ``int64_t``, ``ctypes.c_int64`` /
``c_longlong``).

``dead_entry_guard`` names the block-table parameter of a kernel that
reads one (paged attention): the counterpart of the reference's KRN007
clamp.  The pattern checked (KRN009): every load through the table — a
``__ldg(p + i)`` or a ``p[i]``, where ``p`` is the parameter or a
``const int*`` taken from it — is the first argument of ``max(…, 0)``,
so a ``-1`` dead entry reads row 0 (its tokens are masked) rather than
out of bounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

PTR, INT, FLOAT, INT64 = "ptr", "int", "float", "int64"
KERNELS = "src/repro_torch/kernels"
CSRC = f"{KERNELS}/csrc"


@dataclass(frozen=True)
class KernelContract:
    module: str                   # repo-relative wrapper module
    wrapper: str                  # the function callers call (qualname)
    source: str                   # repo-relative .cu holding the entry
    argtypes: Tuple[str, ...]     # argument kinds, in order
    plain: Optional[str]          # plain version the wrapper runs on CPU
    replaces: Optional[str] = None  # reference KernelContract it ports
    dead_entry_guard: Optional[str] = None  # block-table parameter


def _c(mod: str, wrapper: str, cu: str, argtypes, plain, replaces=None,
       guard=None) -> KernelContract:
    return KernelContract(f"{KERNELS}/{mod}.py", wrapper,
                          f"{CSRC}/{cu}.cu", tuple(argtypes), plain,
                          replaces, guard)


# q, k, v, out, lse (or null), B, S, KVp, gp, hd, stream
_FLASH = [PTR] * 5 + [INT] * 5 + [PTR]
# do, q, k, v, out, lse, D, dq, dk, dv, B, S, KVp, gp, hd, stream
_FLASH_BWD = [PTR] * 10 + [INT] * 5 + [PTR]

#: ``extern "C"`` symbol -> contract
KERNEL_CONTRACTS: Dict[str, KernelContract] = {
    "paged_attention_bf16": _c(
        "paged_attention", "paged_attention", "paged_attention",
        [PTR] * 8 + [INT] * 8 + [PTR], "paged_attention_plain",
        "paged_attention_pallas", guard="block_table"),
    "int8_matmul_s8s32": _c(
        "int8_matmul", "int8_matmul", "int8_matmul",
        [PTR] * 5 + [INT] * 5 + [PTR], "int8_matmul_plain",
        "int8_matmul_pallas"),
    "flash_attention_bf16": _c(
        "flash_attention", "flash_attention", "flash_attention", _FLASH,
        "flash_attention_plain", "flash_attention_pallas"),
    "flash_attention_f32": _c(
        "flash_attention", "flash_attention", "flash_attention", _FLASH,
        "flash_attention_plain", "flash_attention_pallas"),
    # the backward kernels have no TPU counterpart: the reference trains
    # through XLA's autodiff
    "flash_attention_bwd_bf16_wgmma": _c(
        "flash_attention", "flash_attention_bwd", "flash_attention_bwd",
        _FLASH_BWD, "flash_attention_bwd_plain"),
    "flash_attention_bwd_bf16": _c(
        "flash_attention", "flash_attention_bwd", "flash_attention_bwd",
        _FLASH_BWD, "flash_attention_bwd_plain"),
    "flash_attention_bwd_f32": _c(
        "flash_attention", "flash_attention_bwd", "flash_attention_bwd",
        _FLASH_BWD, "flash_attention_bwd_plain"),
    "rowwise_quant": _c(
        "quant", "rowwise_quant", "rowwise_quant",
        [INT, PTR, PTR, PTR, INT, INT, INT, INT, INT, FLOAT, PTR],
        "rowwise_quant_plain", "rowwise_quant_pallas"),
    "rowwise_quant_kv": _c(
        "quant", "rowwise_quant_into", "rowwise_quant",
        [INT] + [PTR] * 7 + [INT] * 5 + [INT64] * 6
        + [INT, INT, INT, FLOAT, PTR],
        "rowwise_quant_into_plain", "rowwise_quant_pallas"),
    "selective_scan_f32": _c(
        "selective_scan", "selective_scan", "selective_scan",
        [PTR] * 9 + [INT] * 5 + [PTR], "selective_scan_plain",
        "selective_scan_pallas"),
    "selective_scan_bwd_f32": _c(
        "selective_scan", "SelectiveScanFn.backward", "selective_scan_bwd",
        [PTR] * 16 + [INT] * 5 + [PTR], "selective_scan_bwd_plain"),
    "wkv_f32": _c(
        "wkv", "wkv", "wkv", [PTR] * 8 + [INT] * 6 + [PTR], "wkv_plain",
        "wkv_pallas"),
    "wkv_bwd_f32": _c(
        "wkv", "WKVFn.backward", "wkv_bwd", [PTR] * 14 + [INT] * 4 + [PTR],
        "wkv_bwd_plain"),
    # an occupancy query (cudaOccupancyMaxActiveClusters): no tensor in,
    # so no plain route; it returns a count, or minus a cudaError_t
    "wkv_bwd_clusters": _c(
        "wkv", "bwd_clusters", "wkv_bwd", [INT] * 4, None),
}


def counterparts(reference_kernel: str) -> Tuple[str, ...]:
    """The port's entries that replace one reference Pallas contract
    (``paged_attention_pallas`` -> ``("paged_attention_bf16",)``)."""
    return tuple(sym for sym, c in KERNEL_CONTRACTS.items()
                 if c.replaces == reference_kernel)
