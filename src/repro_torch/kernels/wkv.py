"""RWKV-6 wkv recurrence: the CUDA kernel and its plain version.

Replaces the TPU kernel ``wkv_pallas`` (``repro/kernels/wkv.py``), which
computes the same recurrence as the time mix's ``_wkv_chunk_scan``: per
head, ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` and ``y_t = r_t^T (S_{t-1} +
diag(u) k_t v_t^T)``, from a zero state.  Both versions here also return
the final state ``S_T``, which the prefill hands to the decode cache (the
TPU kernel keeps it in VMEM scratch and drops it).

The kernel (``csrc/wkv.cu``) is bound by the bytes it moves and by the
serial chain in t; on the H100 its step loop is held by instruction issue
and latency (see the source). A thread keeps ``npt`` rows by ``COLS``
columns of the state in registers, so each word it reads serves 4 columns;
``N / npt`` threads share a column, and their partial outputs meet in
shared memory once a chunk; the u-bonus, rank one in m, is one dot product
per timestep (``y_t[m] = r_t . S[:, m] + v_t[m] * ((r_t o u) . k_t)``);
timesteps are staged through a ``cp.async`` ring. ``plan`` picks ``npt``
and how many blocks share a (batch, head) from the shape and the SM count.
It takes any sequence length, so the ``ops.wkv`` padding of the reference
(identity decay, zero r/k/v: it changes neither y nor the state) is not
needed.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

HEAD_SIZES = (8, 16, 32, 64, 128)     # N values compiled in
MAX_THREADS = 512                     # csrc MAX_THREADS
MIN_THREADS = 128                     # a block splits columns down to this
COLS = 4                              # csrc COLS: state columns a thread
ROWS_PER_THREAD = (8, 4)              # npt values compiled in (<= N)
WARPS_PER_SM = 8                      # below this, columns split finer
# r, k, v, w, u, y, s_fin, B, S, H, N, npt, msplit, stream (csrc/wkv.cu)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """One launch: each thread keeps ``npt`` rows of ``COLS`` state columns
    (``N / npt`` threads a column), and ``msplit`` blocks share a (batch,
    head), ``N / msplit`` columns each."""
    npt: int
    msplit: int


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, n: int, sms: int) -> Plan:
    """Rows per thread and blocks per (batch, head) for ``[b, *, h, n]`` on
    ``sms`` SMs.

    ``npt`` is 8 where its threads fill ``WARPS_PER_SM`` warps on every
    SM, else 4 (more, shorter chains).  (16 rows a thread lost to 8
    wherever it was timed, on an H100 80GB HBM3 at 700 W: 0.075-0.083 ms
    against 0.059-0.064 at B 8, S 128, H 40, N 64.)
    Columns are split over just enough blocks to keep a block within
    ``MAX_THREADS`` threads, and then further, down to ``MIN_THREADS`` a
    block, until the grid covers every SM (each block stages its whole (b,
    h) and sums its own bonus, so thinner blocks cost more than they add:
    on an H100 at B 1, S 2048, two blocks a head ran in 0.47 ms, four in
    0.62)."""
    def threads(npt: int, msplit: int) -> int:
        return n // msplit // COLS * (n // npt)
    npt = next((c for c in ROWS_PER_THREAD if c <= n and
                b * h * threads(c, 1) >= 32 * WARPS_PER_SM * sms), 4)
    msplit = 1
    while threads(npt, msplit) > MAX_THREADS:
        msplit *= 2
    while (b * h * msplit < sms and n // (2 * msplit) >= COLS
           and threads(npt, 2 * msplit) >= MIN_THREADS):
        msplit *= 2
    return Plan(npt, msplit)


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """The sequential recurrence in f32 (the reference's ``ref.wkv_ref``).

    r, k, v, w: [B, S, H, N]; u: [H, N] -> (y [B, S, H, N], final state
    [B, H, N, N]), both f32."""
    b, s, h, n = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # [B,H,N,N]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], state + uf * kv))
        state = w[:, t, :, :, None] * state + kv
    y = (torch.stack(ys, dim=1) if ys else
         torch.zeros((b, 0, h, n), dtype=torch.float32, device=r.device))
    return y, state


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor):
    """Fused wkv (shapes as the plain version; ragged S is fine).

    CUDA tensors launch the kernel (f32 everywhere, N in ``HEAD_SIZES``);
    CPU tensors take the plain version."""
    b, s, h, n = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, n):
        raise ValueError(f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}")
    if not r.is_cuda:
        return wkv_plain(r, k, v, w, u)
    build.refuse_grad("wkv", r, k, v, w, u)
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise TypeError("wkv kernel takes f32 r, k, v, w and u")
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv kernel: head size {n} (compiled: "
                         f"{HEAD_SIZES})")
    for t in (k, v, w, u):
        if t.device != r.device:
            raise ValueError("wkv: tensors on different devices")
    r, k, v, w = (build.aligned(t) for t in (r, k, v, w))
    u = u.contiguous()
    y = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b == 0 or h == 0:
        return y, s_fin
    p = plan(b, h, n, build.sm_count(r.device.index))
    fn = build.entry("wkv", "wkv_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), y.data_ptr(), s_fin.data_ptr(), b, s, h, n,
                   p.npt, p.msplit, stream), "wkv")
    wkv.launches += 1
    return y, s_fin


wkv.launches = 0
