"""fleetlint for the PyTorch port: static invariant analysis.

Pure-``ast`` passes over ``src/repro_torch`` that keep the port's tested
invariants from regressing silently: virtual-clock purity, no host sync
inside device programs, allocator-accounting encapsulation, the ctypes
contracts of the CUDA kernels, and exception/telemetry-schema hygiene.
See ``analysis/README.md``.
"""
from repro_torch.analysis.core import (BaselineError, DEFAULT_BASELINE,  # noqa: F401
                                 FILE_PASSES, Finding, PROJECT_PASSES,
                                 Report, lint_file, load_baseline,
                                 run_lint)

__all__ = ["BaselineError", "DEFAULT_BASELINE", "FILE_PASSES", "Finding",
           "PROJECT_PASSES", "Report", "lint_file", "load_baseline",
           "run_lint"]
