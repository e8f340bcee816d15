"""Causal flash attention (prefill): the CUDA kernel and its plain version.

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention.py``).  Causal softmax attention over a whole window with
positions 0..S-1 is what the reference's ``attention.full_attention`` and
``chunked_attention`` compute on every prefill whose sliding window does
not bite, so ``attention_apply`` routes those prefills here.

The layout is the grouped one ``attention_apply`` already has, q
``[B, S, KVp, gp, hd]`` and k, v ``[B, S, KVp, hd]``, so KV heads are never
repeated: the kernel (``csrc/flash_attention.cu``) packs the gp query heads
of a kv head as rows ``s*gp + g`` that share each K/V tile, skips the tiles
wholly above the diagonal and masks ragged edges, so any S works (the TPU
wrapper's rule that S divides the block sizes does not carry over).  The
route is chosen by dtype, never on a failure: bf16 runs on the bf16 tensor
cores (``mma.sync`` m16n8k16 with f32 accumulators, 128 query rows by
64-key tiles double-buffered with ``cp.async``, P split into two bf16
halves so the P.V product keeps 16 bits of P); f32 keeps the CUDA-core
kernel, since tensor cores would round f32 to TF32.  At the admission
round it is bound by bytes and the launch, at a long prefill by tensor-core
operations.  The plain version is the reference's ``full_attention`` math
with the causal mask.

Training on the card goes through :class:`FlashAttentionFn`: its forward
also writes the log-sum-exp of each query row (``lse``, only when a
gradient is wanted: the serving path passes a null pointer), its backward
launches ``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`).
The TPU side has no backward kernel (the reference trains through XLA's
autodiff of ``full_attention``); the plain backward is autograd of the
plain version (:func:`flash_attention_bwd_plain`).  The backward's route
is a function of dtype and head dim (:func:`bwd_route`), never of a
failure.  bf16 at hd 64 and 128, the widths of every full-size config,
takes the ``wgmma`` kernels: a dK/dV pass and a dQ pass, each with a TMA
producer warp feeding two consumer warpgroups through an mbarrier ring,
bound by the tensor-core operations (seven tile products where a fused
pass would do five) and then by the L2 traffic of re-reading the other
side's tiles.  Any other bf16 head dim up to 256 takes the ``mma.sync``
kernels (bound by the same operations and the shared-memory reads that
feed them); f32 keeps the CUDA-core kernels.  No route uses
floating-point atomics, so a training step on the card repeats bit for
bit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

MAX_HD = 256
NEG_INF = -1e30
_ENTRIES = {torch.bfloat16: "flash_attention_bf16",
            torch.float32: "flash_attention_f32"}
# the backward's routes (see :func:`bwd_route`) and their C entries
_BWD_ENTRIES = {"wgmma": "flash_attention_bwd_bf16_wgmma",
                "mma_sync": "flash_attention_bwd_bf16",
                "f32": "flash_attention_bwd_f32"}
WGMMA_HDS = (64, 128)
MAX_WGMMA_GP = 64       # a wgmma tile holds at least one whole position
# q, k, v, out, lse (or null), B, S, KVp, gp, hd, stream
# (csrc/flash_attention.cu)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# do, q, k, v, out, lse, D (scratch), dq, dk, dv, B, S, KVp, gp, hd, stream
# (csrc/flash_attention_bwd.cu)
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Materialized causal softmax in f32 (``full_attention`` with query
    and key positions 0..S-1).  q: [B, S, KVp, gp, hd]; k, v:
    [B, S, KVp, hd] -> [B, S, KVp, gp, hd] in q's dtype."""
    s, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k.float()) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.to(q.dtype)


def flash_attention_bwd_plain(do: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor):
    """``(dq, dk, dv)`` of :func:`flash_attention_plain` by autograd, each
    in its input's dtype (the kernel's plain version)."""
    with torch.enable_grad():
        q_, k_, v_ = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_plain(q_, k_, v_)
        return torch.autograd.grad(out, (q_, k_, v_), do)


def _check(q, k, v, what: str):
    b, s, kvp, gp, hd = q.shape
    if k.shape != (b, s, kvp, hd) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not q.is_cuda:
        return
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes bf16 or f32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HD:
        raise ValueError(f"{what} kernel: head dim {hd} (max {MAX_HD})")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: tensors on different devices")


def _forward(q, k, v, want_lse: bool):
    """Launch the forward kernel: ``(out, lse or None)``."""
    b, s, kvp, gp, hd = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, kvp, s * gp), dtype=torch.float32,
                       device=q.device) if want_lse else None)
    if out.numel() == 0:
        return out, lse
    fn = build.entry("flash_attention", _ENTRIES[q.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if lse is None else lse.data_ptr(), b, s, kvp, gp,
                   hd, stream), "flash_attention")
    flash_attention.launches += 1
    return out, lse


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel that a CUDA call of ``dtype`` at head dim ``hd``
    launches: ``"wgmma"`` (bf16 at hd 64 or 128, the widths of every
    full-size config), ``"mma_sync"`` (bf16 at any other hd up to 256) or
    ``"f32"`` (the CUDA-core kernels).  Chosen by shape, never on a
    failure."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if hd in WGMMA_HDS else "mma_sync"


def flash_attention_bwd(do: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor):
    """``(dq, dk, dv)`` of the causal attention ``out`` of q, k, v, from the
    upstream gradient ``do`` and the forward's ``lse`` ([B, KVp, S*gp]
    f32), by the backward kernel of :func:`bwd_route` (CUDA tensors, bf16
    or f32, hd <= 256); CPU tensors take
    :func:`flash_attention_bwd_plain`."""
    _check(q, k, v, "flash_attention_bwd")
    b, s, kvp, gp, hd = q.shape
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)}, out "
                         f"{tuple(out.shape)}, q {tuple(q.shape)}")
    if not q.is_cuda:
        return flash_attention_bwd_plain(do, q, k, v)
    if do.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError(f"flash_attention_bwd: do {do.dtype}, out "
                        f"{out.dtype}, q {q.dtype}")
    if lse.shape != (b, kvp, s * gp) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}")
    route = bwd_route(q.dtype, hd)
    if route == "wgmma" and gp > MAX_WGMMA_GP:
        raise ValueError(f"flash_attention_bwd: {gp} query heads a kv head "
                         f"(the bf16 kernel at hd {hd} takes at most "
                         f"{MAX_WGMMA_GP})")
    # TMA reads q, do, k and v from 16-byte-aligned bases
    do, q, k, v, out, lse = (build.aligned(t)
                             for t in (do, q, k, v, out, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    scratch = torch.empty_like(lse)
    fn = build.entry("flash_attention_bwd", _BWD_ENTRIES[route],
                     _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   out.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, kvp, gp,
                   hd, stream), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[route] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = dict.fromkeys(_BWD_ENTRIES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel, differentiable through the backward kernel.
    The forward writes ``lse`` and saves q, k, v, out and lse only when an
    input needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        want = any(ctx.needs_input_grad)
        out, lse = _forward(q, k, v, want)
        if want:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(do, q, k, v, out, lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention over one prefill window (shapes as the plain
    version; any S).

    CUDA tensors go through :class:`FlashAttentionFn` (q, k, v all bf16 or
    all f32, hd <= 256); CPU tensors take the plain version."""
    _check(q, k, v, "flash_attention")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    return FlashAttentionFn.apply(q, k, v)


flash_attention.launches = 0
