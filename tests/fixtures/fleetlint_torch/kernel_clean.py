"""fleetlint fixture: a kernel wrapper that meets its contract."""
import ctypes

import torch

from repro_torch.kernels import build

_I, _P = ctypes.c_int, ctypes.c_void_p
# x, y, n, scale, stream
_ARGTYPES = [_P] * 2 + [_I] + [ctypes.c_float, _P]


def axpy_plain(x, scale):
    return x * scale


def axpy(x, scale):
    if not x.is_cuda:
        return axpy_plain(x, scale)
    y = torch.empty_like(x)
    fn = build.entry("axpy", "axpy_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), y.data_ptr(), x.numel(), scale, stream),
                "axpy")
    return y
