"""Paged decode attention: the CUDA kernel and its plain version.

Replaces the TPU kernel ``paged_attention_pallas`` (``repro/kernels/
paged_attention.py``), which runs on every decode step of every attention
layer.  One query token per sequence attends to that sequence's KV, stored
in fixed-size blocks of a shared pool and found through its block-table row
(layout contract in ``runtime/paging.py``).

The kernel (``csrc/paged_attention.cu``) is bound by the KV bytes it reads:
one thread block per (sequence, kv head) stages each live K/V block once in
shared memory for the gp query rows that share it, and walks only the
``ceil(lengths[b] / P)`` live table entries, so dead entries and the trash
row are never read.  Softmax statistics stay in f32 on chip for the whole
walk.  The plain version is the twin of the reference's XLA block walk
``ops.paged_attention_xla``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

THREADS = 128                     # the kernel's block size
MAX_HD = 256
GROUP_SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 16)   # gp values compiled in
SMEM_LIMIT = 48 * 1024            # static launch limit without opt-in
# q, k_pool, v_pool, block_table, lengths, out, b, kvp, gp, hd, page, mb,
# stream (csrc/paged_attention.cu)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


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
    smem = 4 * (gp * hd + 2 * page * hd + gp * page + 3 * gp)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention kernel: block size {page} x head "
                         f"dim {hd} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")
    for t in (k_pool, v_pool, block_table, lengths):
        if t.device != q.device:
            raise ValueError("paged_attention: tensors on different devices")
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    block_table, lengths = block_table.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = build.entry("paged_attention", "paged_attention_bf16", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   b, kvp, gp, hd, page, mb, stream), "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
