"""Row-wise absmax int8 quantization: the CUDA kernel and its plain version,
standalone and fused into the int8 KV cache write.

Replaces the TPU kernel ``rowwise_quant_pallas`` (``repro/kernels/
quant.py``).  Per row: ``scale = max(absmax, 1e-8) / 127`` and ``q =
clip(round(x / scale), -127, 127)`` as int8, which is also what the int8 KV
cache of the reference (``attention._cache_quant``) stores per token and
head.  The scale
is computed as XLA runs the reference under ``jit`` (the reference's
servers are jitted): the division by 127 is folded into a product with the
f32 reciprocal ``INV_QMAX``.  ``x / scale`` is a true division and rounding
is half to even, so the kernel's codes and scales equal the plain
version's bit for bit.

Two entries, one kernel (``csrc/rowwise_quant.cu``), one launch count:

* ``rowwise_quant(x)``: ``[M, K]`` rows to codes and scales;
* ``rowwise_quant_into(k, v, ...)``: a step's k and v rows quantized and
  written straight into the int8 KV cache at their slots, in one launch
  (what two row-wise quants and four ``index_copy_`` or slice copies do
  in the plain version).

The kernel is bound by its bytes, and at the KV cache's 64-row decode
shape by the launch: ``plan`` gives each row ``g`` lanes of 8- or 16-byte
loads, the row stays in registers and is read once, the absmax is a
shuffle reduction, and codes go out packed.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

INT8_QMAX = 127.0
INV_QMAX = float(torch.tensor(1.0 / INT8_QMAX, dtype=torch.float32))
MAX_VECTORS = 8                  # csrc quant_vec_kernel: R, vectors a lane
THREADS_PER_SM = 2048            # one wave of the card: SMs x this
_TYPES = (torch.bfloat16, torch.float32)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# f32, x, q, scale, m, k, vb, g, r, inv_qmax, stream (csrc/rowwise_quant.cu)
_ARGTYPES = [_I, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# f32, k, v, kq, vq, ks, vs, slot, b, s, h, t, hd, qs_b, qs_t, qs_h, ss_b,
# ss_t, ss_h, vb, g, r, inv_qmax, stream
_KV_ARGTYPES = ([_I] + [_P] * 7 + [_I] * 5 + [_L] * 6
                + [_I, _I, _I, ctypes.c_float, _P])


class Plan(NamedTuple):
    """``g`` lanes a row, each loading ``r`` vectors of ``vb`` bytes; ``r``
    0 is the scalar path (a warp a row)."""
    vb: int
    g: int
    r: int


SCALAR = Plan(0, 32, 0)


@functools.lru_cache(maxsize=None)
def plan(k: int, itemsize: int, rows: int, sms: int) -> Plan:
    """The launch for ``rows`` rows of ``k`` elements of ``itemsize`` bytes
    on ``sms`` SMs: 8-byte vectors where the row is a whole number of them
    and its lanes for all rows fit one wave (more lanes a row, each with
    fewer true divisions to chain), else 16-byte vectors; lanes a power of
    two up to 32, vectors a lane a power of two up to ``MAX_VECTORS``; the
    scalar path for a row of neither (or too long).  Measured on an H100
    80GB HBM3 at 700 W, bf16 rows of 128: 8-byte vectors ran M 64 in
    0.0068 ms and M 8192 in 0.0078, 16-byte ones in 0.0071-0.0077 and
    0.0082; 16 384 rows (two waves at 8 bytes) ran faster at 16.  (The
    wrapper also takes the scalar path for a pointer or stride off its
    boundary.)"""
    nbytes = k * itemsize
    for vb in (8, 16):
        if nbytes == 0 or nbytes % vb:
            continue
        nv = nbytes // vb
        g = 1
        while g < min(nv, 32):
            g *= 2
        r = 1
        while g * r < nv:
            r *= 2
        if r > MAX_VECTORS:
            continue
        if vb == 8 and nbytes % 16 == 0 and rows * g > sms * THREADS_PER_SM:
            continue                          # two waves: take 16 bytes
        return Plan(vb, g, r)
    return SCALAR


def rowwise_quant_plain(x: torch.Tensor):
    """x: [M, K] float -> (q [M, K] int8, scale [M, 1] f32)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * INV_QMAX
    q = torch.div(xf, scale).round_().clamp_(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def rowwise_quant(x: torch.Tensor):
    """x: [M, K] bf16 or f32 -> (q [M, K] int8, scale [M, 1] f32).

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if x.ndim != 2:
        raise ValueError(f"rowwise_quant takes [M, K], got {tuple(x.shape)}")
    if x.dtype not in _TYPES:
        raise TypeError(f"rowwise_quant takes bf16 or f32, got {x.dtype}")
    if not x.is_cuda:
        return rowwise_quant_plain(x)
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scale
    x = x.contiguous()
    p = plan(k, x.element_size(), m, build.sm_count(x.device.index))
    if p.r and x.data_ptr() % p.vb:
        p = SCALAR
    fn = build.entry("rowwise_quant", "rowwise_quant", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(int(x.dtype == torch.float32), x.data_ptr(), q.data_ptr(),
                   scale.data_ptr(), m, k, *p, INV_QMAX, stream),
                "rowwise_quant")
    rowwise_quant.launches += 1
    return q, scale


rowwise_quant.launches = 0


def write_slots(buf: torch.Tensor, val: torch.Tensor,
                slot: Optional[torch.Tensor] = None) -> None:
    """Write ``val`` [B, S, ...] into the cache buffer ``buf`` [B, T, ...]
    in place (cast to its dtype): with ``slot`` (a 0-d integer tensor,
    S = 1), at that slot; without, the prefill layout: token i at slot i
    for S < T, else the last T tokens ring-aligned, token i at slot i % T
    (what the reference's ``_prefill_kv`` writes)."""
    val = val.to(buf.dtype)
    if slot is not None:
        buf.index_copy_(1, slot.reshape(1).long(), val)
        return
    s, t = val.shape[1], buf.shape[1]
    if s >= t:
        buf.copy_(torch.roll(val[:, s - t:], (s - t) % t, dims=1))
    else:
        buf[:, :s] = val


def rowwise_quant_into_plain(k: torch.Tensor, v: torch.Tensor,
                             k_q: torch.Tensor, v_q: torch.Tensor,
                             k_scale: torch.Tensor, v_scale: torch.Tensor,
                             slot: Optional[torch.Tensor] = None) -> None:
    """The int8 KV write in plain torch: ``rowwise_quant_plain`` of k and
    of v [B, S, H, K], then ``write_slots`` of codes and scales into
    k_q / v_q [B, T, H, K] int8 and k_scale / v_scale [B, T, H, 1] f32, in
    place."""
    for src, q_buf, s_buf in ((k, k_q, k_scale), (v, v_q, v_scale)):
        q, scale = rowwise_quant_plain(src.reshape(-1, src.shape[-1]))
        write_slots(q_buf, q.reshape(src.shape), slot)
        write_slots(s_buf, scale.reshape(*src.shape[:-1], 1), slot)


def rowwise_quant_into(k: torch.Tensor, v: torch.Tensor, k_q: torch.Tensor,
                       v_q: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor,
                       slot: Optional[torch.Tensor] = None) -> None:
    """Quantize a step's k and v [B, S, H, K] (bf16 or f32) row-wise and
    write codes and scales into the int8 KV cache, in place: k_q / v_q
    [B, T, H, K] int8, k_scale / v_scale [B, T, H, 1] f32.  ``slot`` (a
    0-d int32 tensor on the cache's device, S = 1) is the decode slot;
    without it, the prefill layout of :func:`write_slots`.

    The buffers may be views (a super-block of a stacked cache): CUDA
    tensors launch one kernel that writes through their strides, and
    raise where the kernel does not take them (codes not of unit stride
    in K, k and v buffers of other strides, other dtypes or devices) —
    a destination is never copied, or the write would land in a copy.
    CPU tensors take the plain version."""
    b, s, h, hd = k.shape
    t = k_q.shape[1]
    if (v.shape != k.shape or k_q.shape != (b, t, h, hd)
            or v_q.shape != k_q.shape or k_scale.shape != (b, t, h, 1)
            or v_scale.shape != k_scale.shape
            or (slot is not None and (s != 1 or slot.numel() != 1))):
        raise ValueError(f"rowwise_quant_into: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, k_q {tuple(k_q.shape)}, v_q "
                         f"{tuple(v_q.shape)}, scales {tuple(k_scale.shape)} "
                         f"{tuple(v_scale.shape)}, slot "
                         f"{None if slot is None else tuple(slot.shape)}")
    if not k.is_cuda:
        return rowwise_quant_into_plain(k, v, k_q, v_q, k_scale, v_scale,
                                        slot)
    if k.dtype not in _TYPES or v.dtype != k.dtype:
        raise TypeError(f"rowwise_quant_into takes bf16 or f32 k and v, got "
                        f"{k.dtype}, {v.dtype}")
    if (k_q.dtype != torch.int8 or v_q.dtype != torch.int8
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise TypeError("rowwise_quant_into writes int8 codes and f32 scales")
    if slot is not None and slot.dtype != torch.int32:
        raise TypeError(f"rowwise_quant_into: slot must be int32, got "
                        f"{slot.dtype}")
    bufs = (v, k_q, v_q, k_scale, v_scale) + (() if slot is None else (slot,))
    if any(t_.device != k.device for t_ in bufs):
        raise ValueError("rowwise_quant_into: tensors on different devices")
    if (k_q.stride() != v_q.stride() or k_scale.stride() != v_scale.stride()
            or (hd > 1 and k_q.stride(3) != 1)):
        raise ValueError(f"rowwise_quant_into: the kernel writes k and v "
                         f"buffers of one layout with codes of unit stride "
                         f"in K; got strides {k_q.stride()}, {v_q.stride()}, "
                         f"{k_scale.stride()}, {v_scale.stride()}")
    if k.numel() == 0:
        return None
    k, v = k.contiguous(), v.contiguous()
    p = plan(hd, k.element_size(), 2 * b * s * h,
             build.sm_count(k.device.index))
    if p.r:       # the E = vb / itemsize codes of a vector: one E-byte store
        e = p.vb // k.element_size()
        if any((k.data_ptr() % p.vb, v.data_ptr() % p.vb,
                k_q.data_ptr() % e, v_q.data_ptr() % e,
                *(st % e for st in k_q.stride()[:3]))):
            p = SCALAR
    fn = build.entry("rowwise_quant", "rowwise_quant_kv", _KV_ARGTYPES)
    stream = torch.cuda.current_stream(k.device).cuda_stream
    build.check(fn(int(k.dtype == torch.float32), k.data_ptr(), v.data_ptr(),
                   k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
                   v_scale.data_ptr(),
                   None if slot is None else slot.data_ptr(), b, s, h, t, hd,
                   *k_q.stride()[:3], *k_scale.stride()[:3], *p, INV_QMAX,
                   stream), "rowwise_quant_into")
    rowwise_quant.launches += 1
    return None
