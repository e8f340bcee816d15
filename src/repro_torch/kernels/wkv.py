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

Training differentiates through ``WKVFn``: on the card its forward is the
same kernel, also writing the state every ``CKPT_EVERY`` steps
(``checkpoints=True``), and its backward is ``csrc/wkv_bwd.cu`` (``wkv_bwd``):
a first kernel carries dS alone back to every chunk boundary, then every
chunk, its state columns split over a thread-block cluster (``bwd_plan``),
replays itself from its checkpoint and walks back; on the CPU it runs
``wkv_bwd_plain``, the same reverse recurrence step by step.
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
CKPT_EVERY = 64                       # csrc CKPT_EVERY: steps a checkpoint
BWD_HEAD_SIZES = (8, 16, 32, 64)      # N values csrc/wkv_bwd.cu compiles
BWD_CTA_COLS = {8: 8, 16: 16, 32: 16, 64: 32}  # csrc/wkv_bwd.cu Walk::MC
# r, k, v, w, u, y, s_fin, ckpt (or null), B, S, H, N, npt, msplit, stream
# (csrc/wkv.cu)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# r, k, v, w, u, dy, ckpt, ds_fin, xs, dr, dk, dv, dw, du_part, B, S, H, N,
# stream (csrc/wkv_bwd.cu)
_BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


class BwdPlan(NamedTuple):
    """The backward's launch: ``cluster`` CTAs share each chunk's state
    columns (``N / cluster`` each), ``chunks`` chunks of ``CKPT_EVERY``
    steps run at once, and ``split`` says whether the dS carry runs first
    (more than one chunk)."""
    cluster: int
    chunks: int
    split: bool


def bwd_plan(s: int, n: int) -> BwdPlan:
    """The backward kernels' launch for ``s`` steps at head size ``n``
    (``csrc/wkv_bwd.cu``): ``BWD_CTA_COLS[n]`` state columns a CTA, so a
    cluster of ``n / BWD_CTA_COLS[n]`` CTAs a chunk (2 at RWKV-6's 64: 256
    threads and 94.6 KB of shared memory a CTA, two an SM; four CTAs of 16
    columns took 27% longer on an H100 at the RWKV-6 3B training layer,
    ``scripts/bwd_ablations.py``);
    every chunk of ``CKPT_EVERY`` steps is its own cluster once a first
    kernel has carried dS to the chunk boundaries, which it does when
    there is more than one.  Raises on a head size the kernel does not
    compile."""
    if n not in BWD_HEAD_SIZES:
        raise ValueError(f"wkv_bwd kernel: head size {n} (compiled: "
                         f"{BWD_HEAD_SIZES})")
    if s < 0:
        raise ValueError(f"wkv_bwd kernel: sequence length {s}")
    chunks = -(-s // CKPT_EVERY)
    return BwdPlan(n // BWD_CTA_COLS[n], chunks, chunks > 1)


def bwd_clusters(b: int, s: int, h: int, n: int) -> int:
    """Walk clusters the card keeps resident at once for ``[b, s, h, n]``
    (``cudaOccupancyMaxActiveClusters``; needs a card)."""
    fn = build.entry("wkv_bwd", "wkv_bwd_clusters", [ctypes.c_int] * 4)
    count = fn(b, s, h, n)
    if count < 0:
        build.check(-count, "wkv_bwd_clusters")
    return count


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


def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
                  ds_fin=None):
    """The gradient of ``wkv_plain``, walked backward step by step in f32
    as the kernel walks it: the states replayed from a checkpoint every
    ``CKPT_EVERY`` steps, then, with ``dS`` the gradient of ``S_t`` (from
    ``ds_fin``, or zero),

        G = dS + (r_t o u) dy_t^T
        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t,  dk_t = G v_t,
        dv_t = G^T k_t,  dw_t = rowsum(dS o S_{t-1}),
        du += r_t o k_t (dy_t . v_t),  dS <- diag(w_t) dS + r_t dy_t^T.

    Shapes as ``wkv_plain``, dy [B, S, H, N], ds_fin [B, H, N, N] or None
    -> (dr, dk, dv, dw [B, S, H, N], du [H, N]), f32."""
    b, s, h, n = r.shape
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    kv = lambda t: k[:, t, :, :, None] * v[:, t, :, None, :]
    ckpts, state = [], torch.zeros((b, h, n, n), dtype=torch.float32,
                                   device=r.device)
    for t in range(s):
        if t % CKPT_EVERY == 0:
            ckpts.append(state)
        state = w[:, t, :, :, None] * state + kv(t)
    ds = (torch.zeros_like(state) if ds_fin is None else
          ds_fin.float().clone())
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros((h, n), dtype=torch.float32, device=r.device)
    for j in reversed(range(len(ckpts))):
        t0 = j * CKPT_EVERY
        t1 = min(s, t0 + CKPT_EVERY)
        states = [ckpts[j]]                       # S_{t-1}, t = t0 .. t1-1
        for t in range(t0, t1 - 1):
            states.append(w[:, t, :, :, None] * states[-1] + kv(t))
        for t in reversed(range(t0, t1)):
            sp, rt, kt, vt, wt, dyt = (states[t - t0], r[:, t], k[:, t],
                                       v[:, t], w[:, t], dy[:, t])
            g = ds + (rt * uf)[..., None] * dyt[..., None, :]
            dr[:, t] = torch.einsum("bhnm,bhm->bhn",
                                    sp + (uf * kt)[..., None]
                                    * vt[..., None, :], dyt)
            dk[:, t] = torch.einsum("bhnm,bhm->bhn", g, vt)
            dv[:, t] = torch.einsum("bhnm,bhn->bhm", g, kt)
            dw[:, t] = (ds * sp).sum(-1)
            du += (rt * kt * (dyt * vt).sum(-1, keepdim=True)).sum(0)
            ds = wt[..., None] * ds + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du


def _check_shapes(r, k, v, w, u) -> None:
    b, s, h, n = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, n):
        raise ValueError(f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}")


def _launch(r, k, v, w, u, checkpoints: bool):
    """The forward kernel on CUDA tensors -> (y, s_fin, ckpt or None)."""
    b, s, h, n = r.shape
    build.check_inputs("wkv", (r, k, v, w, u), n, HEAD_SIZES)
    r, k, v, w = (build.aligned(t) for t in (r, k, v, w))
    u = u.contiguous()
    y = torch.empty_like(r)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    ckpt = (torch.empty((b, h, -(-s // CKPT_EVERY), n, n),
                        dtype=torch.float32, device=r.device)
            if checkpoints else None)
    if b == 0 or h == 0:
        return y, s_fin, ckpt
    p = plan(b, h, n, build.sm_count(r.device.index))
    fn = build.entry("wkv", "wkv_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
                   0 if ckpt is None else ckpt.data_ptr(), b, s, h, n,
                   p.npt, p.msplit, stream), "wkv")
    wkv.launches += 1
    return y, s_fin, ckpt


def wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
            dy: torch.Tensor, ds_fin=None):
    """The backward kernel (``csrc/wkv_bwd.cu``) on CUDA tensors: the
    gradient of ``wkv`` from the forward's checkpoints ``ckpt`` [B, H,
    ceil(S / CKPT_EVERY), N, N] (``_launch(..., checkpoints=True)``) ->
    (dr, dk, dv, dw, du),
    as ``wkv_bwd_plain``; f32, N in ``BWD_HEAD_SIZES``.  ``du`` sums the
    kernel's partials of each batch row and chunk in a fixed order (no
    atomics)."""
    b, s, h, n = r.shape
    _check_shapes(r, k, v, w, u)
    if not r.is_cuda:
        raise ValueError("wkv_bwd launches on CUDA tensors; the CPU takes "
                         "wkv_bwd_plain")
    extra = (dy,) if ds_fin is None else (dy, ds_fin)
    build.check_inputs("wkv_bwd", (r, k, v, w, u, ckpt, *extra), n,
                       BWD_HEAD_SIZES)
    if (dy.shape != r.shape
            or ckpt.shape != (b, h, -(-s // CKPT_EVERY), n, n)
            or (ds_fin is not None and ds_fin.shape != (b, h, n, n))):
        raise ValueError(f"wkv_bwd: dy {tuple(dy.shape)}, ckpt "
                         f"{tuple(ckpt.shape)} for r {tuple(r.shape)}")
    r, k, v, w, dy, ckpt = (build.aligned(t) for t in (r, k, v, w, dy, ckpt))
    u = u.contiguous()
    if ds_fin is not None:
        ds_fin = build.aligned(ds_fin)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    p = bwd_plan(s, n)
    du_part = torch.empty((b, h, p.chunks, n), dtype=torch.float32,
                          device=r.device)
    if b == 0 or h == 0 or s == 0:
        return (*(t.zero_() for t in (dr, dk, dv, dw)),
                torch.zeros((h, n), dtype=torch.float32, device=r.device))
    # dS entering each chunk's walk, written by the carry kernel
    xs = torch.empty_like(ckpt) if p.split else None
    fn = build.entry("wkv_bwd", "wkv_bwd_f32", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                   u.data_ptr(), dy.data_ptr(), ckpt.data_ptr(),
                   0 if ds_fin is None else ds_fin.data_ptr(),
                   0 if xs is None else xs.data_ptr(),
                   dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                   du_part.data_ptr(), b, s, h, n, stream), "wkv_bwd")
    wkv_bwd.launches += 1
    return dr, dk, dv, dw, du_part.sum((0, 2))


class WKVFn(torch.autograd.Function):
    """``wkv`` with a gradient.  On the card the forward kernel also writes
    the chunk checkpoints, which are saved (under remat they are dropped
    and recomputed with the rest of the block), and the backward launches
    ``wkv_bwd``; on the CPU the forward is ``wkv_plain`` and the backward
    ``wkv_bwd_plain``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        if r.is_cuda:
            if r.shape[-1] not in BWD_HEAD_SIZES:
                raise ValueError(f"wkv: no backward kernel at head size "
                                 f"{r.shape[-1]} ({BWD_HEAD_SIZES})")
            y, s_fin, ckpt = _launch(r, k, v, w, u, checkpoints=True)
        else:
            (y, s_fin), ckpt = wkv_plain(r, k, v, w, u), None
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, ds_fin):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        if r.is_cuda:
            grads = wkv_bwd(r, k, v, w, u, ckpt, dy.float(),
                            None if ds_fin is None else ds_fin.float())
        else:
            grads = wkv_bwd_plain(r, k, v, w, u, dy, ds_fin)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (r, k, v, w, u)))


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor):
    """Fused wkv (shapes as the plain version; ragged S is fine).

    CUDA tensors launch the kernel (f32 everywhere, N in ``HEAD_SIZES``);
    CPU tensors take the plain version.  Where a gradient is needed the
    call goes through ``WKVFn`` (on the card, N in ``BWD_HEAD_SIZES``)."""
    _check_shapes(r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u)):
        return WKVFn.apply(r, k, v, w, u)
    if not r.is_cuda:
        return wkv_plain(r, k, v, w, u)
    y, s_fin, _ = _launch(r, k, v, w, u, checkpoints=False)
    return y, s_fin


wkv.launches = 0
wkv_bwd.launches = 0
