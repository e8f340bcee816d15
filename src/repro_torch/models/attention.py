"""Grouped-query attention with TP-aware head padding (the port of
``repro.models.attention``, dense attention path).

Head padding: head counts that do not divide the tensor-parallel degree are
padded.  We pick the smallest (Hp, KVp) with

    tp | Hp,  tp | KVp,  kv | KVp,  KVp | Hp,  Hp >= H,

replicate each real kv head into its ``KVp // kv`` padded slots and lay the
real q heads of one kv group contiguously across those slots.  Every padded
q slot beyond the real heads carries zero weights, so the math is exact.

Paths:
  * causal prefill — the flash-attention kernel of ``kernels/ops.py``
    (every prefill whose sliding window does not bite)
  * ``full``    — materialized scores (windowed prefill up to 2048 tokens)
  * ``chunked`` — online-softmax loop over kv chunks (longer windowed
    prefill)
  * paged decode / paged chunk prefill — against the block pools of
    ``runtime/paging.py``, through the kernels of ``kernels/ops.py``
  * dense decode — against a :class:`KVCache` (the windowed loop; ring
    buffer under a sliding window, int8 KV written by the row-wise quant
    kernel's fused KV write)

Inside the model group (``core/collectives.py``) attention is head-local:
``wq`` / ``wk`` / ``wv`` are column-parallel, so the rank holds ``KVp /
tp`` kv slots and, since the layout puts each slot's q heads under it,
exactly their ``Hp / tp`` q heads; q/k norms and rope act per head (the
norms' replicated scales through ``to_model``, so their gradients sum
over the ranks' heads), a dense cache holds the rank's kv heads and
``wo`` is row-parallel.  The paged paths belong to the one-device engine
and refuse a group.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
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
    q = pdot(x, params["wq"], policy, split="col").reshape(b, s, -1, hd)
    k = pdot(x, params["wk"], policy, split="col").reshape(b, s, -1, hd)
    v = pdot(x, params["wv"], policy, split="col").reshape(b, s, -1, hd)
    if cfg.qk_norm:
        # a replicated scale over the rank's heads: its gradient sums the
        # ranks' parts
        q = rmsnorm({"scale": collectives.to_model(params["q_norm"]["scale"])},
                    q, cfg.norm_eps)
        k = rmsnorm({"scale": collectives.to_model(params["k_norm"]["scale"])},
                    k, cfg.norm_eps)
    if cfg.rope_theta:          # theta == 0 -> no positional rotation (Jamba)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor,
                    policy: PrecisionPolicy = DEFAULT_POLICY,
                    chunked: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention over a full sequence (prefill) at positions 0..S-1.
    Without a sliding window that bites, the causal flash kernel runs;
    a biting window keeps the plain full / chunked paths.  Returns the
    output and the window's k, v [B, S, KVp, hd]: the reference projects
    them a second time to fill its cache (``transformer._prefill_kv``); the
    same deterministic ops on the same input give the same values, so the
    port hands them over instead."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    kvp = k.shape[2]
    q = q.reshape(b, s, kvp, -1, hd)
    window = cfg.sliding_window
    if not window or s <= window:
        # the mask is exactly causal (prefill positions are 0..S-1), which
        # is what the reference's full and chunked paths both compute
        out = kops.flash_attention(q, k, v)
    else:
        pos1 = positions[0] if positions.ndim == 2 else positions
        if chunked is None:
            chunked = s > 2048
        attend = chunked_attention if chunked else full_attention
        out = attend(q, k, v, pos1, pos1, window)
    out = out.reshape(b, s, -1)
    return pdot(out, params["wo"], policy, split="row"), k, v


class KVCache(NamedTuple):
    """Dense cache of one attention sublayer: the prefill target the engine
    pastes into its paged pools, and the cache the windowed loop decodes
    against.  Prefill and decode write it in place."""
    k: torch.Tensor       # [B, T, KVp, hd]  (bf16, or int8 + scales)
    v: torch.Tensor
    pos: torch.Tensor     # [] int32: tokens seen so far
    k_scale: Optional[torch.Tensor] = None  # [B, T, KVp, 1] f32 (int8 mode)
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _cache_deq(q: torch.Tensor,
               scale: Optional[torch.Tensor]) -> torch.Tensor:
    if scale is None:
        return q.float()
    return q.float() * scale


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
                  lead: Tuple[int, ...] = (), device="cuda") -> KVCache:
    """A fresh dense cache (``lead`` prepends stacking axes, e.g. the
    super-block axis): bf16 k/v, or int8 k/v with f32 scales of one when
    ``cfg.kv_cache_dtype == "int8"``; a sliding window bounds its length.
    Inside the model group it holds the rank's ``KVp / tp`` kv heads."""
    lay = head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    hd = cfg.resolved_head_dim()
    length = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
    heads = lay.KVp // collectives.model_ranks()
    shape = (*lead, batch, length, heads, hd)
    pos = torch.zeros(lead, dtype=torch.int32, device=device)
    if cfg.kv_cache_dtype == "int8":
        sshape = (*lead, batch, length, heads, 1)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       pos,
                       torch.ones(sshape, dtype=torch.float32, device=device),
                       torch.ones(sshape, dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   pos)


def decode_slot(cfg: ModelConfig, pos: torch.Tensor, t: int) -> torch.Tensor:
    """The cache slot a decode step at position ``pos`` writes: the ring
    slot ``pos % t`` under a sliding window, else ``min(pos, t - 1)``."""
    return pos % t if cfg.sliding_window else pos.clamp(max=t - 1)


def decode_attention_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                           cache: KVCache,
                           policy: PrecisionPolicy = DEFAULT_POLICY
                           ) -> torch.Tensor:
    """One-token decode step against a dense cache.  x: [B, 1, D].

    The new token's k/v (quantized in int8 mode, by the fused int8 KV
    write) are written at :func:`decode_slot` and ``pos`` advances, in
    place; attention then reads
    every slot written so far (the whole ring under a sliding window) in
    f32, as the reference does in XLA."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    t = cache.k.shape[1]
    q, k, v = _project_qkv(params, cfg, x, cache.pos.expand(b, 1), policy)
    slot = decode_slot(cfg, cache.pos, t)
    if cache.quantized:          # one launch: quantize k, v and write
        kops.rowwise_quant_into(k, v, cache.k, cache.v, cache.k_scale,
                                cache.v_scale, slot)
    else:
        kops.write_slots(cache.k, k, slot)
        kops.write_slots(cache.v, v, slot)
    valid = (torch.arange(t, device=x.device)
             < torch.clamp(cache.pos + 1, max=t))
    cache.pos.add_(1)
    kvp = k.shape[2]
    # XLA's jit folds the reference's ``/ sqrt(hd)`` into a product with
    # the f32 reciprocal; the same product here gives the same scores
    inv_sqrt = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    qh = q.reshape(b, 1, kvp, -1, hd).float() * inv_sqrt
    scores = torch.einsum("bskgd,btkd->bkgst", qh,
                          _cache_deq(cache.k, cache.k_scale))
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w,
                       _cache_deq(cache.v, cache.v_scale))
    out = out.to(x.dtype).reshape(b, 1, -1)
    return pdot(out, params["wo"], policy, split="row")


def _one_device(what: str) -> None:
    """The paged paths serve the one-device engine: inside a model group
    of several ranks they would attend over part of the heads."""
    if collectives.model_ranks() > 1:
        raise ValueError(f"{what} runs on one device; it is inside a model "
                         f"group of {collectives.model_ranks()} ranks")


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
    _one_device("paged decode")
    b = x.shape[0]
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    paging.append_tokens(state, k[:, 0], v[:, 0])
    kvp = k.shape[2]
    qh = q[:, 0].reshape(b, kvp, -1, hd)          # grouped-query layout
    out = kops.paged_attention(qh, state.k_pool, state.v_pool,
                               state.block_table, state.lengths)
    out = out.reshape(b, 1, -1).to(x.dtype)
    return pdot(out, params["wo"], policy, split="row")


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
    _one_device("paged chunk prefill")
    b, c, _ = x.shape
    hd = cfg.resolved_head_dim()
    q, k, v = _project_qkv(params, cfg, x, positions, policy)
    paging.write_prefill_chunk(state, k[0], v[0], seq, start)
    kvp = k.shape[2]
    qh = q[0].reshape(c, kvp, -1, hd)             # grouped-query layout
    out = kops.paged_chunk_attention(qh, state.k_pool, state.v_pool,
                                     state.block_table[seq], positions[0])
    out = out.reshape(b, c, -1).to(x.dtype)
    return pdot(out, params["wo"], policy, split="row")
