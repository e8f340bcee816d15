"""int8 x int8 -> int32 matrix product: the CUDA kernel and its plain version.

Replaces the TPU kernel ``int8_matmul_pallas`` (``repro/kernels/
int8_matmul.py``).  On the serving path the product runs at decode with M =
live rows (<= 8), where it is bound by the K*N weight bytes it reads, and at
prefill with M = 256 (the Qwen3 admission bucket) or 1024 (an RWKV-6 or
Jamba window), where it is bound by operations.  The kernel
(``csrc/int8_matmul.cu``) runs both on the int8 tensor cores
(``mma.sync.m16n8k32``, exact int32 sums) in two tile configurations that
``plan`` picks by shape: at M <= 16 the weights are the 16-row A operand,
streamed with 16-byte loads straight into registers and transposed to
K-major with byte permutes, and K is split over the grid so every SM
streams weights; above that a 64- or 128-row by 128-column tile
walks K through a 4-stage ``cp.async`` ring in shared memory, split over K
only where the tiles alone would leave SMs idle.  The splits of a tile meet
through an atomic count and, at decode, a zeroed int32 accumulator that
the last split writes out and zeroes again (larger tiles: partial tiles
in a workspace), so the result is exact and order-free and the output
needs no zeroing launch; ragged edges are masked, not padded.  The kernel
equals the plain version bit for bit.

PyTorch has no int8 matrix product of its own on CUDA (``torch._int_mm`` is
a cuBLAS call), so every CUDA int8 product of the port goes through this
kernel, whatever the policy's ``use_pallas`` says; the reference's two
branches give equal int32 results.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DECODE_M = 16            # rows the decode tile takes (two m8 mma tiles)
DECODE_BN, DECODE_BK = 128, 32        # csrc decode_kernel: D_BN, D_BK
TILE_BN, TILE_BK = 128, 64            # csrc tile_kernel: T_BN, T_BK
BLOCKS_PER_SM = 2        # resident blocks of either kernel (launch bounds)
LEAST_K_STEPS = 4        # K steps (32 or 64 bytes) a split keeps at the least
MAX_SPLITS = 8           # K splits of one 64- or 128-row tile at the most
# x, w, out, scratch, counts, m, k, n, bm, per, stream (csrc/int8_matmul.cu)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_zeroed: dict = {}       # (device, stream) -> zeroed (accumulators, counts)


class Plan(NamedTuple):
    """One launch: ``bm`` rows (16: the decode kernel), ``bn`` columns and
    ``bk`` K bytes a step per tile; K cut into ``splits`` runs of ``per``
    steps (the last may be shorter), one grid slice each."""
    bm: int
    bn: int
    bk: int
    splits: int
    per: int


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, K] int8, w: [K, N] int8 -> [M, N] int32.  Exact: int32 on the
    CPU, float64 on CUDA (which has no integer matmul; exact while every
    partial sum stays below 2**53)."""
    if x.is_cuda:
        return (x.double() @ w.double()).to(torch.int32)
    return x.to(torch.int32) @ w.to(torch.int32)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int) -> Plan:
    """The tile and the K splits for an [m, k] x [k, n] product on ``sms``
    SMs.

    M <= 16 takes the decode tile, larger M a 64- (M <= 64) or 128-row
    tile.  K is split so that the grid fills one wave of
    ``BLOCKS_PER_SM`` blocks per SM and no more (a second, partial wave
    costs as much as the first), into runs of at least ``LEAST_K_STEPS``
    K steps, and for the 64- and 128-row tiles into at most
    ``MAX_SPLITS`` runs (each leaves a partial tile to add up)."""
    decode = m <= DECODE_M
    bm = DECODE_M if decode else 64 if m <= 64 else 128
    bn, bk = (DECODE_BN, DECODE_BK) if decode else (TILE_BN, TILE_BK)
    tiles = -(-m // bm) * -(-n // bn)
    k_steps = -(-k // bk)
    want = max(1, BLOCKS_PER_SM * sms // tiles)
    if not decode:
        want = min(want, MAX_SPLITS)
    per = max(min(LEAST_K_STEPS, k_steps), -(-k_steps // want))
    return Plan(bm, bn, bk, -(-k_steps // per), per)


def _zeroed_for(device: torch.device, stream: int, tiles: int,
                tile_ints: int) -> tuple:
    """Zeroed int32 accumulators (``tile_ints`` per tile) and tile counters
    for a split launch on ``stream``.  Each launch leaves them zero again,
    so one pair serves every launch on that stream in turn (each stream has
    its own, so launches that may overlap never share one); they grow to
    the largest launch seen."""
    acc, counts = _zeroed.get((device, stream), (None, None))
    if acc is None or acc.numel() < tiles * tile_ints:
        acc = torch.zeros(max(1, tiles * tile_ints), dtype=torch.int32,
                          device=device)
    if counts is None or counts.numel() < tiles:
        counts = torch.zeros(tiles, dtype=torch.int32, device=device)
    _zeroed[(device, stream)] = acc, counts
    return acc, counts


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, K] int8, w: [K, N] int8 -> [M, N] int32.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} do not multiply")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8, got {x.dtype} x {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"int8_matmul: x on {x.device}, w on {w.device}")
    if not x.is_cuda:
        return int8_matmul_plain(x, w)
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x.device)
    x, w = x.contiguous(), w.contiguous()
    p = plan(m, k, n, build.sm_count(x.device.index))
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = counts = None             # one split: no tile is shared
    if p.splits > 1:
        tiles = -(-m // p.bm) * -(-n // p.bn)
        decode = p.bm == DECODE_M
        scratch, counts = _zeroed_for(x.device, stream, tiles,
                                      p.bm * p.bn if decode else 0)
        if not decode:                  # room for the splits' partials
            scratch = torch.empty(p.splits * tiles * p.bm * p.bn,
                                  dtype=torch.int32, device=x.device)
    fn = build.entry("int8_matmul", "int8_matmul_s8s32", _ARGTYPES)
    build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   None if counts is None else counts.data_ptr(), m, k, n,
                   p.bm, p.per, stream), "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
