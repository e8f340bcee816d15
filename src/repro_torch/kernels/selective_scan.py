"""Mamba-1 selective scan: the CUDA kernel and its plain version.

Replaces the TPU kernel ``selective_scan_pallas`` (``repro/kernels/
selective_scan.py``), which computes the same recurrence as the Mamba
mixer's chunked associative scan (``mamba._chunk_scan``): per channel d,
``h_t = exp(dt_t a_d) h_{t-1} + (dt_t x_t) B_t`` and ``y_t = h_t . C_t +
D_d x_t``, from a zero state.  Both versions here also return the final
state ``h_S`` ``[B, D, N]``, which the prefill hands to the decode cache
(the TPU kernel keeps it in VMEM scratch and drops it).

The kernel (``csrc/selective_scan.cu``) is held by its step loop (one exp
per state and step, and the bytes of x, dt and y).  It keeps a channel's N
states in the registers of ``lanes`` threads (``plan`` picks how many) for
the whole sequence, takes each exp as one ``ex2.approx`` of ``dt * a *
log2(e)``, and each warp stages its timesteps through its own ``cp.async``
ring.  It takes any S and D, so the reference wrapper's padding is not
needed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

STATE_SIZES = (4, 8, 16, 32, 64)     # N values compiled in
LANES = (1, 2, 4, 8)                 # threads a channel, compiled in
MAX_STATES = 8                       # csrc Tile: states a thread keeps
WARPS_PER_SM = 6                     # below this, channels split finer
# x, dt, b, c, a, d, y, h_fin, B, S, D, N, lanes, stream
# (csrc/selective_scan.cu)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def plan(b: int, dim: int, n: int, sms: int) -> int:
    """Threads a channel for ``[b, *, dim]`` channels of ``n`` states on
    ``sms`` SMs: ``MAX_STATES`` states a thread, and more threads a channel
    (fewer states each, down to one) until ``b * dim * lanes`` threads give
    every SM ``WARPS_PER_SM`` warps.  Measured on an H100 80GB HBM3 at
    700 W (N 16): at B 8, S 128, D 8192, 2 lanes ran in 0.059 ms, 1 in
    0.064 and 4 in 0.076; at B 1, S 2048, 4 lanes in 0.17 ms, 8 in 0.23; at
    B 3, S 37, 2 lanes in 0.014 ms, 4 in 0.016.  A plan reads shapes only,
    never data, so a launch stays capturable in a CUDA graph."""
    lanes = max(1, n // MAX_STATES)
    while (lanes < min(n, LANES[-1])
           and b * dim * lanes < 32 * WARPS_PER_SM * sms):
        lanes *= 2
    return lanes


def selective_scan_plain(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """The sequential recurrence in f32 (the reference's
    ``ref.selective_scan_ref``).

    x, dt: [B, S, D]; b, c: [B, S, N]; a: [D, N]; d: [D] -> (y [B, S, D],
    final state [B, D, N]), both f32."""
    bsz, s, dim = x.shape
    x, dt, b, c, a, d = (t.float() for t in (x, dt, b, c, a, d))
    h = torch.zeros((bsz, dim, a.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        a_bar = torch.exp(dt[:, t, :, None] * a)                  # [B,D,N]
        h = a_bar * h + (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]) + d * x[:, t])
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((bsz, 0, dim), dtype=torch.float32, device=x.device))
    return y, h


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """Fused selective scan (shapes as the plain version; ragged S and D
    are fine).

    CUDA tensors launch the kernel (f32 everywhere, N in ``STATE_SIZES``);
    CPU tensors take the plain version."""
    bsz, s, dim = x.shape
    n = a.shape[-1]
    if (dt.shape != x.shape or b.shape != (bsz, s, n) or c.shape != b.shape
            or a.shape != (dim, n) or d.shape != (dim,)):
        raise ValueError(f"selective_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}")
    if not x.is_cuda:
        return selective_scan_plain(x, dt, b, c, a, d)
    build.refuse_grad("selective_scan", x, dt, b, c, a, d)
    if any(t.dtype != torch.float32 for t in (x, dt, b, c, a, d)):
        raise TypeError("selective_scan kernel takes f32 x, dt, b, c, a, d")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan kernel: state size {n} (compiled: "
                         f"{STATE_SIZES})")
    for t in (dt, b, c, a, d):
        if t.device != x.device:
            raise ValueError("selective_scan: tensors on different devices")
    x, dt, b, c = (build.aligned(t) for t in (x, dt, b, c))
    a, d = a.contiguous(), d.contiguous()
    y = torch.empty_like(x)
    h_fin = torch.empty((bsz, dim, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or dim == 0:
        return y, h_fin
    lanes = plan(bsz, dim, n, build.sm_count(x.device.index))
    fn = build.entry("selective_scan", "selective_scan_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                   a.data_ptr(), d.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
                   bsz, s, dim, n, lanes, stream), "selective_scan")
    selective_scan.launches += 1
    return y, h_fin


selective_scan.launches = 0
