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

Training differentiates through ``SelectiveScanFn``: on the card its
forward is the same kernel, also writing ``h`` every ``CKPT_EVERY`` steps
(``checkpoints=True``), and its backward is
``csrc/selective_scan_bwd.cu`` (``selective_scan_bwd``), which replays each
chunk from its checkpoint and walks it back, every chunk at once where
``bwd_plan`` splits the sequence; on the CPU it runs
``selective_scan_bwd_plain``, the same reverse recurrence step by step.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

STATE_SIZES = (4, 8, 16, 32, 64)     # N values compiled in
LANES = (1, 2, 4, 8)                 # threads a channel, compiled in
MAX_STATES = 8                       # csrc Tile: states a thread keeps
WARPS_PER_SM = 6                     # below this, channels split finer
CKPT_EVERY = 64                      # csrc CKPT_EVERY: steps a checkpoint
BWD_THREADS = 256                    # csrc/selective_scan_bwd.cu kThreads
BWD_STATES = 4                       # csrc/selective_scan_bwd.cu NPT
BWD_BLOCKS_PER_SM = 2                # its launch bounds: blocks an SM
# x, dt, b, c, a, d, y, h_fin, ckpt (or null), B, S, D, N, lanes, stream
# (csrc/selective_scan.cu)
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# x, dt, b, c, a, d, dy, ckpt, dh_fin, xs, dx, ddt, db_part, dc_part,
# da_part, dd_part, B, S, D, N, split, stream (csrc/selective_scan_bwd.cu)
_BWD_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def selective_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor,
                             a: torch.Tensor, d: torch.Tensor,
                             dy: torch.Tensor, dh_fin=None):
    """The gradient of ``selective_scan_plain``, walked backward step by
    step in f32 as the kernel walks it: the states replayed from a
    checkpoint every ``CKPT_EVERY`` steps, then, with ``dh`` the gradient
    of ``h_t`` (from ``dh_fin``, or zero) and ``e_t = exp(dt_t a)``,

        dh += dy_t C_t;  dC_t = sum_d dy_t h_t;  dB_t = sum_d dh dt_t x_t;
        dx_t = D dy_t + dt_t (dh . B_t);
        ddt_t = dh . (a e_t h_{t-1} + x_t B_t);
        dA += dh dt_t e_t h_{t-1};  dD += dy_t x_t;  dh <- e_t dh.

    Shapes as ``selective_scan_plain``, dy [B, S, D], dh_fin [B, D, N] or
    None -> (dx, ddt [B, S, D], dB, dC [B, S, N], dA [D, N], dD [D]), f32."""
    bsz, s, dim = x.shape
    x, dt, b, c, a, d, dy = (t.float() for t in (x, dt, b, c, a, d, dy))
    n = a.shape[-1]

    def advance(h, t):
        return (torch.exp(dt[:, t, :, None] * a) * h
                + (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :])
    ckpts, h = [], torch.zeros((bsz, dim, n), dtype=torch.float32,
                               device=x.device)
    for t in range(s):
        if t % CKPT_EVERY == 0:
            ckpts.append(h)
        h = advance(h, t)
    dh = torch.zeros_like(h) if dh_fin is None else dh_fin.float().clone()
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    db, dc = torch.zeros_like(b), torch.zeros_like(c)
    da = torch.zeros_like(a)
    dd = torch.zeros_like(d)
    for j in reversed(range(len(ckpts))):
        t0 = j * CKPT_EVERY
        t1 = min(s, t0 + CKPT_EVERY)
        states = [ckpts[j]]                       # h_{t-1}, t = t0 .. t1-1
        for t in range(t0, t1 - 1):
            states.append(advance(states[-1], t))
        for t in reversed(range(t0, t1)):
            hp = states[t - t0]
            dtt, xt, dyt = dt[:, t], x[:, t], dy[:, t]
            e = torch.exp(dtt[:, :, None] * a)                    # [B,D,N]
            ht = e * hp + (dtt * xt)[:, :, None] * b[:, t, None, :]
            dh = dh + dyt[:, :, None] * c[:, t, None, :]
            dc[:, t] = torch.einsum("bd,bdn->bn", dyt, ht)
            db[:, t] = torch.einsum("bdn,bd->bn", dh, dtt * xt)
            dx[:, t] = d * dyt + dtt * torch.einsum("bdn,bn->bd", dh,
                                                    b[:, t])
            ddt[:, t] = (dh * (a * e * hp
                               + xt[:, :, None] * b[:, t, None, :])).sum(-1)
            da += (dh * dtt[:, :, None] * e * hp).sum(0)
            dd += (dyt * xt).sum(0)
            dh = e * dh
    return dx, ddt, db, dc, da, dd


def _check_shapes(x, dt, b, c, a, d) -> None:
    bsz, s, dim = x.shape
    n = a.shape[-1]
    if (dt.shape != x.shape or b.shape != (bsz, s, n) or c.shape != b.shape
            or a.shape != (dim, n) or d.shape != (dim,)):
        raise ValueError(f"selective_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a {tuple(a.shape)}, d "
                         f"{tuple(d.shape)}")


def _launch(x, dt, b, c, a, d, checkpoints: bool):
    """The forward kernel on CUDA tensors -> (y, h_fin, ckpt or None)."""
    bsz, s, dim = x.shape
    n = a.shape[-1]
    build.check_inputs("selective_scan", (x, dt, b, c, a, d), n,
                       STATE_SIZES)
    x, dt, b, c = (build.aligned(t) for t in (x, dt, b, c))
    a, d = a.contiguous(), d.contiguous()
    y = torch.empty_like(x)
    h_fin = torch.empty((bsz, dim, n), dtype=torch.float32, device=x.device)
    ckpt = (torch.empty((bsz, dim, -(-s // CKPT_EVERY), n),
                        dtype=torch.float32, device=x.device)
            if checkpoints else None)
    if bsz == 0 or dim == 0:
        return y, h_fin, ckpt
    lanes = plan(bsz, dim, n, build.sm_count(x.device.index))
    fn = build.entry("selective_scan", "selective_scan_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                   a.data_ptr(), d.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
                   0 if ckpt is None else ckpt.data_ptr(), bsz, s, dim, n,
                   lanes, stream), "selective_scan")
    selective_scan.launches += 1
    return y, h_fin, ckpt


def bwd_blocks(dim: int, n: int) -> int:
    """Blocks of the backward kernel over ``dim`` channels of ``n`` states
    (``BWD_THREADS`` threads, ``n / BWD_STATES`` lanes a channel): the
    leading size of its dB and dC partials."""
    per_block = BWD_THREADS // (n // BWD_STATES)
    return -(-dim // per_block)


class BwdPlan(NamedTuple):
    """The backward's launch: ``chunks`` chunks of ``CKPT_EVERY`` steps;
    with ``split`` a first kernel carries dh to every chunk boundary and the
    walk runs every (b, chunk, channel block) at once, else each (b,
    channel block) walks its chunks in turn."""
    chunks: int
    split: bool


@functools.lru_cache(maxsize=None)
def bwd_plan(b: int, s: int, dim: int, n: int, sms: int) -> BwdPlan:
    """Split the backward's sequence at the checkpoints where its (b,
    channel block) blocks do not fill ``BWD_BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs (B 1, S 2048 at Jamba's d_inner 8192: 128 blocks for 132
    SMs) and there is more than one chunk; the split adds a walk of dh
    alone (one exp an element and step), so a grid that fills the card
    (B 8, S 128: 1024 blocks) walks its chunks in turn.  Reads shapes
    only.  Raises on a state size the kernel does not compile."""
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan_bwd kernel: state size {n} "
                         f"(compiled: {STATE_SIZES})")
    if min(b, s, dim, sms) < 0:
        raise ValueError(f"selective_scan_bwd: B {b}, S {s}, D {dim}")
    chunks = -(-s // CKPT_EVERY)
    split = (chunks > 1
             and b * bwd_blocks(dim, n) < BWD_BLOCKS_PER_SM * sms)
    return BwdPlan(chunks, split)


def selective_scan_bwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                       ckpt: torch.Tensor, dy: torch.Tensor, dh_fin=None):
    """The backward kernel (``csrc/selective_scan_bwd.cu``) on CUDA
    tensors: the gradient of ``selective_scan`` from the forward's
    checkpoints ``ckpt`` [B, D, ceil(S / CKPT_EVERY), N]
    (``_launch(..., checkpoints=True)``) -> (dx, ddt, dB, dC, dA, dD), as
    ``selective_scan_bwd_plain``, split over the sequence where
    ``bwd_plan`` says so.  dB and dC sum the kernel's per-block partials,
    dA and dD its partials of each batch row (and chunk, when split), in a
    fixed order (no atomics)."""
    bsz, s, dim = x.shape
    n = a.shape[-1]
    _check_shapes(x, dt, b, c, a, d)
    if not x.is_cuda:
        raise ValueError("selective_scan_bwd launches on CUDA tensors; the "
                         "CPU takes selective_scan_bwd_plain")
    extra = (dy,) if dh_fin is None else (dy, dh_fin)
    build.check_inputs("selective_scan_bwd", (x, dt, b, c, a, d, ckpt,
                                              *extra), n, STATE_SIZES)
    if (dy.shape != x.shape
            or ckpt.shape != (bsz, dim, -(-s // CKPT_EVERY), n)
            or (dh_fin is not None and dh_fin.shape != (bsz, dim, n))):
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)}, ckpt "
                         f"{tuple(ckpt.shape)} for x {tuple(x.shape)}")
    x, dt, b, c, dy, ckpt = (build.aligned(t)
                             for t in (x, dt, b, c, dy, ckpt))
    a, d = a.contiguous(), d.contiguous()
    if dh_fin is not None:
        dh_fin = dh_fin.contiguous()
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    if bsz == 0 or dim == 0 or s == 0:
        return (dx.zero_(), ddt.zero_(), torch.zeros_like(b),
                torch.zeros_like(c), torch.zeros_like(a), torch.zeros_like(d))
    p = bwd_plan(bsz, s, dim, n, build.sm_count(x.device.index))
    groups = p.chunks if p.split else 1
    blocks = bwd_blocks(dim, n)
    db_part, dc_part = (torch.empty((blocks, bsz, s, n), dtype=torch.float32,
                                    device=x.device) for _ in range(2))
    da_part = torch.empty((groups, bsz, dim, n), dtype=torch.float32,
                          device=x.device)
    dd_part = torch.empty((groups, bsz, dim), dtype=torch.float32,
                          device=x.device)
    # dh entering each chunk's walk, written by the carry kernel
    xs = torch.empty_like(ckpt) if p.split else None
    fn = build.entry("selective_scan_bwd", "selective_scan_bwd_f32",
                     _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
                   a.data_ptr(), d.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
                   0 if dh_fin is None else dh_fin.data_ptr(),
                   0 if xs is None else xs.data_ptr(),
                   dx.data_ptr(), ddt.data_ptr(), db_part.data_ptr(),
                   dc_part.data_ptr(), da_part.data_ptr(), dd_part.data_ptr(),
                   bsz, s, dim, n, int(p.split), stream), "selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return (dx, ddt, db_part.sum(0), dc_part.sum(0), da_part.sum((0, 1)),
            dd_part.sum((0, 1)))


class SelectiveScanFn(torch.autograd.Function):
    """``selective_scan`` with a gradient.  On the card the forward kernel
    also writes the chunk checkpoints, which are saved (under remat they
    are dropped and recomputed with the rest of the block), and the
    backward launches ``selective_scan_bwd``; on the CPU the forward is
    ``selective_scan_plain`` and the backward ``selective_scan_bwd_plain``.
    """

    @staticmethod
    def forward(ctx, x, dt, b, c, a, d):
        ctx.set_materialize_grads(False)
        if x.is_cuda:
            y, h_fin, ckpt = _launch(x, dt, b, c, a, d, checkpoints=True)
        else:
            (y, h_fin), ckpt = selective_scan_plain(x, dt, b, c, a, d), None
        ctx.save_for_backward(x, dt, b, c, a, d, ckpt)
        return y, h_fin

    @staticmethod
    def backward(ctx, dy, dh_fin):
        x, dt, b, c, a, d, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if x.is_cuda:
            grads = selective_scan_bwd(
                x, dt, b, c, a, d, ckpt, dy.float(),
                None if dh_fin is None else dh_fin.float())
        else:
            grads = selective_scan_bwd_plain(x, dt, b, c, a, d, dy, dh_fin)
        return tuple(g.to(t.dtype) for g, t in zip(grads,
                                                   (x, dt, b, c, a, d)))


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, d: torch.Tensor):
    """Fused selective scan (shapes as the plain version; ragged S and D
    are fine).

    CUDA tensors launch the kernel (f32 everywhere, N in ``STATE_SIZES``);
    CPU tensors take the plain version.  Where a gradient is needed the
    call goes through ``SelectiveScanFn``."""
    _check_shapes(x, dt, b, c, a, d)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, b, c, a, d)):
        return SelectiveScanFn.apply(x, dt, b, c, a, d)
    if not x.is_cuda:
        return selective_scan_plain(x, dt, b, c, a, d)
    y, h_fin, _ = _launch(x, dt, b, c, a, d, checkpoints=False)
    return y, h_fin


selective_scan.launches = 0
selective_scan_bwd.launches = 0
