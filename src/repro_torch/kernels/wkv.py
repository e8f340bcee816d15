"""RWKV-6 wkv recurrence: the CUDA kernel and its plain version.

Replaces the TPU kernel ``wkv_pallas`` (``repro/kernels/wkv.py``), which
computes the same recurrence as the time mix's ``_wkv_chunk_scan``: per
head, ``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` and ``y_t = r_t^T (S_{t-1} +
diag(u) k_t v_t^T)``, from a zero state.  Both versions here also return
the final state ``S_T``, which the prefill hands to the decode cache (the
TPU kernel keeps it in VMEM scratch and drops it).

The kernel (``csrc/wkv.cu``) is bound by the bytes it moves: one thread
block per (head, batch) row, one thread per state column kept in registers
for the whole sequence, timesteps staged through shared memory in chunks.
It takes any sequence length, so the ``ops.wkv`` padding of the reference
(identity decay, zero r/k/v: it changes neither y nor the state) is not
needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_SIZES = (8, 16, 32, 64, 128)     # N values compiled in
# r, k, v, w, u, y, s_fin, B, S, H, N, stream (csrc/wkv.cu)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise TypeError("wkv kernel takes f32 r, k, v, w and u")
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv kernel: head size {n} (compiled: "
                         f"{HEAD_SIZES})")
    for t in (k, v, w, u):
        if t.device != r.device:
            raise ValueError("wkv: tensors on different devices")
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    y = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b == 0 or h == 0:
        return y, s_fin
    fn = build.entry("wkv", "wkv_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), y.data_ptr(), s_fin.data_ptr(), b, s, h, n,
                   stream), "wkv")
    wkv.launches += 1
    return y, s_fin


wkv.launches = 0
