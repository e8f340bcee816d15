"""Grouped-query attention with TP-aware head padding (the port of
``repro.models.attention``, dense attention path).

Head padding: head counts that do not divide the tensor-parallel degree are
padded.  We pick the smallest (Hp, KVp) with

    tp | Hp,  tp | KVp,  kv | KVp,  KVp | Hp,  Hp >= H,

replicate each real kv head into its ``KVp // kv`` padded slots and lay the
real q heads of one kv group contiguously across those slots.  Every padded
q slot beyond the real heads carries zero weights, so the math is exact.

Paths:
  * ``full``    — materialized scores (prefill windows up to 2048 tokens)
  * ``chunked`` — online-softmax loop over kv chunks (longer prefill)
  * paged decode / paged chunk prefill — against the block pools of
    ``runtime/paging.py``, through the kernels of ``kernels/ops.py``
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.quantization import pdot
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.runtime import paging

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Head-padding layout
# ---------------------------------------------------------------------------
class HeadLayout(NamedTuple):
    H: int            # real q heads
    KV: int           # real kv heads
    Hp: int           # padded q heads
    KVp: int          # padded kv heads
    gp: int           # padded group size  Hp // KVp


def head_layout(h: int, kv: int, tp: int) -> HeadLayout:
    tp = max(tp, 1)
    kvp = math.lcm(kv, tp)
    hp = ((max(h, kvp) + kvp - 1) // kvp) * kvp
    assert hp % tp == 0 and kvp % tp == 0 and hp % kvp == 0
    return HeadLayout(h, kv, hp, kvp, hp // kvp)


def q_slot_map(layout: HeadLayout) -> torch.Tensor:
    """[Hp] -> real q head index, or -1 for a pad slot."""
    H, KV, Hp, _, _ = layout
    g = H // KV                       # real group size
    per_kv = Hp // KV                 # padded q slots per real kv head
    src = -torch.ones((Hp,), dtype=torch.int32)
    for c in range(KV):
        for r in range(g):
            src[c * per_kv + r] = c * g + r
    return src


def kv_slot_map(layout: HeadLayout) -> torch.Tensor:
    """[KVp] -> real kv head index (every padded kv slot is a replica)."""
    return torch.arange(layout.KVp, dtype=torch.int32) // (layout.KVp // layout.KV)


def _pad_heads(w: torch.Tensor, slot_map: torch.Tensor, head_dim: int,
               axis: int) -> torch.Tensor:
    """Expand the real-head axis ``axis`` (n_real*hd wide) of ``w`` to the
    padded layout following slot_map (-1 -> zero heads)."""
    if torch.equal(slot_map, torch.arange(len(slot_map), dtype=slot_map.dtype)):
        return w                                  # no padding: same layout
    shape = list(w.shape)
    heads = w.unflatten(axis, (-1, head_dim))
    safe = slot_map.clamp_min(0).long().to(w.device)
    keep = (slot_map >= 0).to(w.device, w.dtype)
    view = [1] * heads.ndim
    view[axis] = -1
    out = heads.index_select(axis, safe) * keep.reshape(view)
    shape[axis] = len(slot_map) * head_dim
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def attention_init(cfg: ModelConfig, n: int, generator: torch.Generator,
                   device, tp: int = 1) -> Dict:
    """``n`` stacked attention mixers, f32, made on ``device``."""
    hd = cfg.resolved_head_dim()
    d = cfg.d_model
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    qmap, kvmap = q_slot_map(lay), kv_slot_map(lay)

    def proj(heads, smap):
        w = dense_init((n, d, heads * hd), generator, device, d ** -0.5)
        return _pad_heads(w, smap, hd, axis=2)
    p = {"wq": proj(cfg.num_heads, qmap),
         "wk": proj(cfg.num_kv_heads, kvmap),
         "wv": proj(cfg.num_kv_heads, kvmap)}
    # rows of wo follow the padded q layout (pad rows zero)
    wo = dense_init((n, cfg.num_heads * hd, d), generator, device,
                    (cfg.num_heads * hd) ** -0.5)
    p["wo"] = _pad_heads(wo, qmap, hd, axis=1)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init((n, hd), device)
        p["k_norm"] = rmsnorm_init((n, hd), device)
    return p


# ---------------------------------------------------------------------------
# Score paths
# ---------------------------------------------------------------------------
def _mask(qpos, kpos, window: int):
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def full_attention(q, k, v, qpos, kpos, window: int = 0) -> torch.Tensor:
    """q: [B,S,KVp,gp,hd]  k,v: [B,T,KVp,hd] -> [B,S,KVp,gp,hd]."""
    hd = q.shape[-1]
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = torch.where(_mask(qpos, kpos, window)[None, None, None],
                         scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, qpos, kpos, window: int = 0,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax loop over kv chunks (flash-style, plain PyTorch)."""
    b, s, kvp, gp, hd = q.shape
    t = k.shape[1]
    nchunk = -(-t // chunk)
    pad = nchunk * chunk - t
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=2 ** 30)
    qf = q.float() / math.sqrt(hd)
    m = torch.full((b, kvp, gp, s), NEG_INF, device=q.device)
    l = torch.zeros((b, kvp, gp, s), device=q.device)
    acc = torch.zeros((b, kvp, gp, s, hd), device=q.device)
    for c in range(nchunk):
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        pb = kpos[c * chunk:(c + 1) * chunk]
        s_blk = torch.einsum("bskgd,btkd->bkgst", qf, kb)
        s_blk = torch.where(_mask(qpos, pb, window)[None, None, None],
                            s_blk, NEG_INF)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        p = torch.exp(s_blk - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)   # [B,S,KVp,gp,hd]


# ---------------------------------------------------------------------------
# Block-level apply
# ---------------------------------------------------------------------------
def _project_qkv(params, cfg: ModelConfig, x, positions,
                 policy: PrecisionPolicy):
    hd = cfg.resolved_head_dim()
    b, s, _ = x.shape
    q = pdot(x, params["wq"], policy).reshape(b, s, -1, hd)
    k = pdot(x, params["wk"], policy).reshape(b, s, -1, hd)
    v = pdot(x, params["wv"], policy).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope_theta:          # theta == 0 -> no positional rotation (Jamba)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor,
                    policy: PrecisionPolicy = DEFAULT_POLICY,
                    chunked: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention over a full sequence (prefill).  Returns the output
    and the window's k, v [B, S, KVp, hd]: the reference projects them a
    second time to fill its cache (``transformer._prefill_kv``); the same
    deterministic ops on the same input give the same values, so the port
    hands them over instead."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    kvp = k.shape[2]
    q = q.reshape(b, s, kvp, -1, hd)
    pos1 = positions[0] if positions.ndim == 2 else positions
    if chunked is None:
        chunked = s > 2048
    if chunked:
        out = chunked_attention(q, k, v, pos1, pos1, cfg.sliding_window)
    else:
        out = full_attention(q, k, v, pos1, pos1, cfg.sliding_window)
    out = out.reshape(b, s, -1)
    return pdot(out, params["wo"], policy), k, v


class KVCache(NamedTuple):
    """Dense prefill-target cache of one attention sublayer (bf16 KV; the
    engine pastes it into its paged pools)."""
    k: torch.Tensor       # [B, T, KVp, hd]
    v: torch.Tensor


def paged_decode_attention_apply(params: Dict, cfg: ModelConfig,
                                 x: torch.Tensor,
                                 state: paging.PagedKVState,
                                 positions: torch.Tensor,
                                 policy: PrecisionPolicy = DEFAULT_POLICY
                                 ) -> torch.Tensor:
    """One-token decode step against a paged KV cache.  x: [B, 1, D].

    Every batch slot sits at its own context length, so the caller passes
    per-sequence rope ``positions`` [B, 1] (== ``state.lengths[:, None]``).
    The new token is appended into the slot's current block (in place)
    and attention walks the block table in the kernel — the full KV is
    never materialized."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    paging.append_tokens(state, k[:, 0], v[:, 0])
    kvp = k.shape[2]
    qh = q[:, 0].reshape(b, kvp, -1, hd)          # grouped-query layout
    out = kops.paged_attention(qh, state.k_pool, state.v_pool,
                               state.block_table, state.lengths)
    out = out.reshape(b, 1, -1).to(x.dtype)
    return pdot(out, params["wo"], policy)


def paged_chunk_attention_apply(params: Dict, cfg: ModelConfig,
                                x: torch.Tensor,
                                state: paging.PagedKVState,
                                positions: torch.Tensor, seq: int, start: int,
                                policy: PrecisionPolicy = DEFAULT_POLICY
                                ) -> torch.Tensor:
    """One prefill *chunk* of sequence ``seq`` against the paged cache.

    x: [1, C, D]; positions: [1, C] absolute, ``start .. start+C-1`` (start
    block-aligned, C a whole number of blocks).  The chunk's KV is pasted into the
    sequence's blocks first (in place), then attention reads the pool back
    through the block-table walk — queries see the paged prefix written by
    earlier chunks plus the in-chunk causal triangle."""
    b, c, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    paging.write_prefill_chunk(state, k[0], v[0], seq, start)
    kvp = k.shape[2]
    qh = q[0].reshape(c, kvp, -1, hd)             # grouped-query layout
    out = kops.paged_chunk_attention(qh, state.k_pool, state.v_pool,
                                     state.block_table[seq], positions[0])
    out = out.reshape(b, c, -1).to(x.dtype)
    return pdot(out, params["wo"], policy)
