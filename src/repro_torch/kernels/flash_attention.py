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
# q, k, v, out, B, S, KVp, gp, hd, stream (csrc/flash_attention.cu)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention over one prefill window (shapes as the plain
    version; any S).

    CUDA tensors launch the kernel (q, k, v all bf16 or all f32, hd <=
    256); CPU tensors take the plain version."""
    b, s, kvp, gp, hd = q.shape
    if k.shape != (b, s, kvp, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    build.refuse_grad("flash_attention", q, k, v)
    if q.dtype not in _ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16 or f32 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HD:
        raise ValueError(f"flash_attention kernel: head dim {hd} "
                         f"(max {MAX_HD})")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: tensors on different devices")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = build.entry("flash_attention", _ENTRIES[q.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b, s, kvp, gp, hd, stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
