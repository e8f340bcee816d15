"""Paged decode attention: the CUDA kernel and its plain version.

Replaces the TPU kernel ``paged_attention_pallas`` (``repro/kernels/
paged_attention.py``), which runs on every decode step of every attention
layer.  One query token per sequence attends to that sequence's KV, stored
in fixed-size blocks of a shared pool and found through its block-table row
(layout contract in ``runtime/paging.py``).

The kernel (``csrc/paged_attention.cu``) is bound by the KV bytes it reads,
so it splits each sequence's block table over the grid (flash-decoding):
``plan`` cuts the table into ``splits`` runs of ``cols`` columns from the
batch, the kv heads, the table width and the SM count alone (never from
``lengths``, so a decode step's grid has a fixed shape). Each live split
streams its K/V rows through a ``cp.async`` ring in shared memory, scores
and sums them on the bf16 tensor cores with the gp query rows in registers
and the softmax in f32 registers, and leaves a partial ``(m, l, acc)``; the
last split of a (sequence, kv head) to finish combines them in split order,
in the same launch, through a per-(sequence, head) arrival counter that it
sets back to zero. Splits past ``lengths[b]`` read nothing, so dead entries
and the trash row are never read. The plain version is the twin of the
reference's XLA block walk ``ops.paged_attention_xla``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

MAX_HD = 256
GROUP_SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 16)   # gp values the kernel takes
SMEM_LIMIT = 232448               # shared memory a block may opt into
BLOCKS_PER_SM = 2                 # blocks the plan aims at per SM
LEAST_COLS = 8                    # table columns a split keeps at the least
MAX_SPLITS = 16                   # the last split reads every partial
# q, k_pool, v_pool, block_table, lengths, out, partial, counts, b, kvp, gp,
# hd, page, mb, cols, splits, stream (csrc/paged_attention.cu)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_workspace: dict = {}             # (device, stream) -> counters, partials


class Plan(NamedTuple):
    """One launch: the table cut into ``splits`` runs of ``cols`` columns
    (the last may be shorter), one grid slice each."""
    splits: int
    cols: int


@functools.lru_cache(maxsize=None)
def plan(b: int, kvp: int, mb: int, sms: int) -> Plan:
    """The split of an ``[b, mb]`` block table over ``b * kvp`` (sequence,
    kv head) pairs on ``sms`` SMs.

    Each pair is cut into as many splits as fit the grid into one wave of
    ``BLOCKS_PER_SM`` blocks per SM (a second, partial wave costs as much
    as the first), at most ``MAX_SPLITS``, each of at least ``LEAST_COLS``
    columns (or the whole table).  A table of ``LEAST_COLS`` columns or
    fewer, as the Qwen3-14B engine's (128 tokens, 8 columns), is one split:
    no partials, no combine."""
    want = min(MAX_SPLITS, max(1, BLOCKS_PER_SM * sms // max(1, b * kvp)))
    cols = max(min(LEAST_COLS, mb), -(-mb // want), 1)
    return Plan(max(1, -(-mb // cols)), cols)


def smem_bytes(hd: int) -> int:
    """Shared memory of one block (csrc ``smem_bytes``): the 16 padded q
    rows, the warps' and the block's softmax statistics, and the ring of
    64-token K and V tiles (3 stages, 2 at a head dim above 128), rows
    padded to a power of two of at least 16."""
    hdp = max(16, 1 << (hd - 1).bit_length())
    stages = 3 if hdp <= 128 else 2
    small = (2 * 4 * 16 + 2 * 16 + 1 + 3) // 4 * 4
    return 16 * hdp * 2 + 4 * small + stages * 2 * 64 * hdp * 2


def _buffers(device: torch.device, stream: int, pairs: int,
             floats: int) -> tuple:
    """Zeroed int32 arrival counters for ``pairs`` (sequence, kv head)
    pairs and f32 scratch of ``floats`` for the splits' partials, for a
    launch on ``stream``.  Launches on one stream run in turn and each
    leaves the counters zero again, so one pair of tensors serves them all;
    it grows to the largest launch seen.  Outgrown tensors are kept, so a
    CUDA graph that captured them stays valid."""
    held = _workspace.setdefault((device, stream), [])
    if not held or held[-1][0].numel() < pairs or held[-1][1].numel() < floats:
        old = held[-1] if held else (torch.empty(0), torch.empty(0))
        held.append((
            torch.zeros(max(pairs, old[0].numel()), dtype=torch.int32,
                        device=device),
            torch.empty(max(floats, old[1].numel()), dtype=torch.float32,
                        device=device)))
    return held[-1]


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Online softmax over the block-table columns, one block per sequence
    in flight at a time (the reference's ``ops.paged_attention_xla``).

    q: [B, KVp, gp, hd]; k_pool/v_pool: [num_rows, P, KVp, hd];
    block_table: [B, MB] int32; lengths: [B] int32 -> [B, KVp, gp, hd]."""
    b, kvp, gp, hd = q.shape
    page = k_pool.shape[1]
    mb = block_table.shape[1]
    qf = q.float() / torch.sqrt(torch.tensor(float(hd)))
    m = torch.full((b, kvp, gp), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvp, gp), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvp, gp, hd), dtype=torch.float32, device=q.device)
    offs = torch.arange(page, device=q.device)
    for j in range(mb):
        rows = block_table[:, j].clamp_min(0).long()
        k = k_pool[rows].float()                      # [B, P, KVp, hd]
        v = v_pool[rows].float()
        s = torch.einsum("bkgd,bpkd->bkgp", qf, k)
        mask = (j * page + offs)[None, :] < lengths[:, None]    # [B, P]
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # zero masked terms explicitly: for a fully-masked row (lengths ==
        # 0) m_new stays -1e30 and exp(s - m_new) would be 1, leaking the
        # clamped row 0; the kernel returns exactly 0 there
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgp,bpkd->bkgd", p, v)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """One decode token of paged attention (shapes as the plain version).

    CUDA tensors launch the kernel (bf16 q and pools, int32 table and
    lengths); CPU tensors take the plain version."""
    b, kvp, gp, hd = q.shape
    rows, page, kvp2, hd2 = k_pool.shape
    mb = block_table.shape[1]
    if (v_pool.shape != k_pool.shape or (kvp2, hd2) != (kvp, hd)
            or block_table.shape[0] != b or lengths.shape != (b,)):
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)}")
    if not q.is_cuda:
        return paged_attention_plain(q, k_pool, v_pool, block_table, lengths)
    if (q.dtype, k_pool.dtype, v_pool.dtype) != (torch.bfloat16,) * 3:
        raise TypeError("paged_attention kernel takes bf16 q and pools")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention kernel takes int32 table and lengths")
    if gp not in GROUP_SIZES or hd > MAX_HD:
        raise ValueError(f"paged_attention kernel: gp={gp} (compiled: "
                         f"{GROUP_SIZES}), hd={hd} (max {MAX_HD})")
    smem = smem_bytes(hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention kernel: head dim {hd} needs "
                         f"{smem} B of shared memory (> {SMEM_LIMIT})")
    for t in (k_pool, v_pool, block_table, lengths):
        if t.device != q.device:
            raise ValueError("paged_attention: tensors on different devices")
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    block_table, lengths = block_table.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0 or kvp == 0:
        return out
    if mb == 0:
        return out.zero_()
    p = plan(b, kvp, mb, build.sm_count(q.device.index))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counts = partial = None                 # one split: no partials
    if p.splits > 1:
        counts, partial = _buffers(q.device, stream, b * kvp,
                                   b * kvp * p.splits * gp * (hd + 2))
    fn = build.entry("paged_attention", "paged_attention_bf16", _ARGTYPES)
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   None if partial is None else partial.data_ptr(),
                   None if counts is None else counts.data_ptr(),
                   b, kvp, gp, hd, page, mb, p.cols, p.splits, stream),
                "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
