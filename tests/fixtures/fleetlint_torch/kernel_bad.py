"""fleetlint fixture: a kernel wrapper that breaks its contract."""
import ctypes

import torch

from repro_torch.kernels import build

# x, y, n, stream: the scale argument is missing (KRN004)
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p]


def axpy_plain(x, scale):
    return x * scale


def axpy(x, scale):
    y = torch.empty_like(x)
    fn = build.entry("axpy", "axpy_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    try:
        fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)   # KRN007
    except OSError:
        return axpy_plain(x, scale)          # KRN008 (a fallback)
    return y


def rogue(x):
    fn = build.entry("axpy", "axpy_rogue", [ctypes.c_void_p])   # KRN001
    build.check(fn(x.data_ptr()), "rogue")
