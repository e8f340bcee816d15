"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library under ``build/repro_torch_kernels/``
at the root of the checkout, named by a hash of the source and the flags, so
an edited source is rebuilt and an unchanged one is not.  All sources that
need building compile at once, one ``nvcc`` each.  The wrappers load a
library with ``ctypes`` on their first CUDA call; ``python3 chip_smoke.py``
builds everything up front.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all) whose library is missing.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (registers, shared memory and spills per kernel).  Raises with the
    compiler's output if any source fails."""
    todo = [n for n in (sources() if names is None else names)
            if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    reports, failed = {}, []
    for name, (proc, tmp) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{text}")
        else:
            os.replace(tmp, library_path(name))   # atomic for parallel loaders
            reports[name] = text
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of ``csrc/<name>.cu``, returning ``int``
    (a ``cudaError_t``).  Built, loaded and typed on the first call and
    cached, so a launch pays only for the call itself."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel entry."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")


def check_inputs(what: str, tensors, size: int, sizes) -> None:
    """Raise unless ``tensors`` are all f32 on one device and ``size`` (the
    head or state size) is one of the ``sizes`` the kernel compiles."""
    import torch
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} kernel takes f32 inputs")
    if size not in sizes:
        raise ValueError(f"{what} kernel: size {size} (compiled: {sizes})")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")


def aligned(t):
    """``t`` contiguous on a 16-byte boundary (kernels that copy 16 bytes
    at a time take their inputs so)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the launch plans
    size their grids by it)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count
