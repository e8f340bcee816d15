"""Front door of the port's kernels, as ``repro.kernels.ops`` is of the
reference's: the model code calls ``int8_matmul``, ``paged_attention``,
``flash_attention``, ``wkv``, ``selective_scan``, ``rowwise_quant`` and
the int8 KV write ``rowwise_quant_into`` from here (``write_slots`` is the
cache write of a bf16 KV cache), and ``paged_chunk_attention``, which is
plain PyTorch as it is XLA code in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.int8_matmul import int8_matmul  # noqa: F401
from repro_torch.kernels.paged_attention import paged_attention  # noqa: F401
from repro_torch.kernels.quant import (rowwise_quant,  # noqa: F401
                                      rowwise_quant_into, write_slots)
from repro_torch.kernels.selective_scan import selective_scan  # noqa: F401
from repro_torch.kernels.wkv import wkv  # noqa: F401


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table_row: torch.Tensor,
                          qpos: torch.Tensor) -> torch.Tensor:
    """Chunk-prefill attention for ONE sequence against its paged KV (the
    reference's ``ops.paged_chunk_attention_xla``).

    A C-token query block (one prefill chunk, already pasted into the pool
    by ``paging.write_prefill_chunk``) attends causally to every earlier
    position of its own sequence, walking the sequence's block-table row
    with an online softmax, one block in flight at a time.

    q: [C, KVp, gp, hd]; k_pool/v_pool: [num_rows, P, KVp, hd];
    table_row: [MB] int32 (-1 = unallocated); qpos: [C] int32 absolute
    positions of the chunk.  Returns [C, KVp, gp, hd].  Blocks past the
    chunk fall to the causal mask: their positions exceed every query's.
    """
    c, kvp, gp, hd = q.shape
    page = k_pool.shape[1]
    qf = q.float() / torch.sqrt(torch.tensor(float(hd)))
    m = torch.full((kvp, gp, c), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((kvp, gp, c), dtype=torch.float32, device=q.device)
    acc = torch.zeros((kvp, gp, c, hd), dtype=torch.float32, device=q.device)
    offs = torch.arange(page, device=q.device)
    for j in range(table_row.shape[0]):
        entry = table_row[j]
        row = entry.clamp_min(0).long()
        k = k_pool[row].float()                       # [P, KVp, hd]
        v = v_pool[row].float()
        s = torch.einsum("ckgd,pkd->kgcp", qf, k)
        mask = ((j * page + offs)[None, :] <= qpos[:, None]) & (entry >= 0)
        s = torch.where(mask[None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask[None, None], torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("kgcp,pkd->kgcd", p, v)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]         # [KVp, gp, C, hd]
    return out.permute(2, 0, 1, 3).to(q.dtype)
