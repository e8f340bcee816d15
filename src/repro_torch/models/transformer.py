"""Model composition (the port of ``repro.models.transformer``, dense
attention stacks).

Layer stacks are built from *super-blocks*, the smallest periodic unit of
the layer pattern (one attention + MLP sublayer for a dense model), and
every parameter carries a leading super-block axis, as in the reference.
A :class:`~repro_torch.core.partition.PartitionPlan` splits the stack into
contiguous segments; each runs its super-blocks under its own precision
policy.  MoE, Mamba and RWKV stacks are later slices of the port and are
refused.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, embedding_init, lm_logits,
                                       mlp_apply, mlp_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.runtime.paging import PagedKVState


# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------
def pattern_period(cfg: ModelConfig) -> int:
    p = cfg.attn_every if cfg.mixer == "hybrid" else 1
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return p


def sublayer_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, bool], ...]:
    p = pattern_period(cfg)
    pat = tuple((cfg.layer_mixer(j), cfg.is_moe_layer(j)) for j in range(p))
    # the pattern must be offset-invariant (periodicity check)
    for i in range(cfg.num_layers):
        assert (cfg.layer_mixer(i), cfg.is_moe_layer(i)) == pat[i % p], cfg.name
    return pat


def _dense_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, bool], ...]:
    pat = sublayer_pattern(cfg)
    if any(kind != "attention" or is_moe for kind, is_moe in pat):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention stacks; MoE, Mamba "
            f"and RWKV sublayers are not ported yet")
    return pat


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def model_init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
               tp: int = 1) -> Dict:
    """Random f32 parameters in the reference's tree, made on ``device``
    (``generator`` must live there too).  Values differ from the
    reference's ``jax.random`` init; parity tests bridge JAX weights."""
    pat = _dense_pattern(cfg)
    n = cfg.num_layers // len(pat)
    d = cfg.d_model
    layers = {f"sub_{j}": {
        "norm1": rmsnorm_init((n, d), device),
        "mixer": attn.attention_init(cfg, n, generator, device, tp),
        "norm2": rmsnorm_init((n, d), device),
        "mlp": mlp_init(n, d, cfg.d_ff, cfg.glu, generator, device)}
        for j in range(len(pat))}
    params = {"embed": embedding_init(cfg.vocab_size, d, generator, device),
              "layers": layers,
              "final_norm": rmsnorm_init((d,), device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embedding_init(cfg.vocab_size, d, generator,
                                           device)
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int = 1,
               device="cuda") -> Dict:
    """Dense prefill-target caches, one per sublayer, stacked over
    super-blocks: ``{"sub_j": KVCache([n_super, B, T, KVp, hd] x 2)}``."""
    pat = _dense_pattern(cfg)
    n = cfg.num_layers // len(pat)
    lay = attn.head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    length = (min(max_len, cfg.sliding_window) if cfg.sliding_window
              else max_len)
    shape = (n, batch, length, lay.KVp, cfg.resolved_head_dim())
    return {f"sub_{j}": attn.KVCache(
                torch.zeros(shape, dtype=torch.bfloat16, device=device),
                torch.zeros(shape, dtype=torch.bfloat16, device=device))
            for j in range(len(pat))}


def init_paged_decode_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                            block_size: int, tp: int = 1,
                            max_blocks: Optional[int] = None,
                            dtype=torch.bfloat16, device="cuda") -> Dict:
    """Per-sublayer paged KV caches for continuous-batching decode.

    Every attention sublayer gets its own block pool, and table and
    lengths are kept per super-block (the engine keeps them in lockstep
    from its host-side mirror): ``{"sub_j": PagedKVState}`` with pools
    ``[n_super, NB+1, P, KVp, hd]``, table ``[n_super, B, MB]`` and
    lengths ``[n_super, B]``.  The reference broadcasts one cache over the
    stack; here each super-block owns its storage because the writes are
    in place.
    """
    pat = sublayer_pattern(cfg)
    bad = [kind for kind, _ in pat if kind != "attention"]
    if bad:
        raise ValueError(f"paged decode needs an attention-only stack; "
                         f"{cfg.name} has {sorted(set(bad))} sublayers")
    if cfg.sliding_window:
        raise ValueError("paged decode does not support sliding windows")
    if cfg.kv_cache_dtype == "int8":
        raise ValueError("paged decode does not support int8 KV caches")
    lay = attn.head_layout(cfg.num_heads, cfg.num_kv_heads, tp)
    hd = cfg.resolved_head_dim()
    n = cfg.num_layers // len(pat)
    if max_blocks is None:
        max_blocks = num_blocks
    pool = (n, num_blocks + 1, block_size, lay.KVp, hd)

    def one():
        return PagedKVState(
            torch.zeros(pool, dtype=dtype, device=device),
            torch.zeros(pool, dtype=dtype, device=device),
            -torch.ones((n, batch, max_blocks), dtype=torch.int32,
                        device=device),
            torch.zeros((n, batch), dtype=torch.int32, device=device))
    return {f"sub_{j}": one() for j in range(len(pat))}


def first_paged_state(cache) -> Optional[PagedKVState]:
    """The first PagedKVState in a cache dict (None when fully dense)."""
    for st in (cache or {}).values():
        if isinstance(st, PagedKVState):
            return st
    return None


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------
def _prefill_kv(cache: attn.KVCache, k: torch.Tensor, v: torch.Tensor):
    """Write the prefill window's k/v into one layer's dense cache, in
    place (the reference returns a new cache)."""
    s, t = k.shape[1], cache.k.shape[1]
    for buf, val in ((cache.k, k), (cache.v, v)):
        if s >= t:        # keep only the trailing window, ring-aligned so
            # that position p lands in slot p % t
            buf.copy_(torch.roll(val[:, s - t:], (s - t) % t, dims=1))
        else:
            buf[:, :s] = val


def _sublayer_apply(sub: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, policy: PrecisionPolicy,
                    cache=None, decode: bool = False,
                    chunk: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One attention + MLP sublayer.  ``cache`` is this super-block's view:
    decode and ``chunk`` (``(seq, start)``, chunked paged prefill) take a
    PagedKVState, plain prefill an optional dense KVCache."""
    h = rmsnorm(sub["norm1"], x, cfg.norm_eps)
    if decode:
        if not isinstance(cache, PagedKVState):
            raise NotImplementedError("dense-cache decode is not ported yet")
        out = attn.paged_decode_attention_apply(sub["mixer"], cfg, h, cache,
                                                positions, policy)
    elif chunk is not None:
        out = attn.paged_chunk_attention_apply(sub["mixer"], cfg, h, cache,
                                               positions, chunk[0], chunk[1],
                                               policy)
    else:
        out, k, v = attn.attention_apply(sub["mixer"], cfg, h, positions,
                                         policy)
        if cache is not None:
            _prefill_kv(cache, k, v)
    x = x + out
    h2 = rmsnorm(sub["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(sub["mlp"], h2, cfg.act, cfg.glu, policy)


class LMOutput(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Dict]


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            plan: Optional[PartitionPlan] = None, tp: int = 1,
            cache=None, decode: bool = False,
            chunk: Optional[Tuple[int, int]] = None) -> LMOutput:
    """Unified forward; caches are updated in place and returned.

    * prefill: tokens [B, S], cache None or a dense prefill-target cache
    * decode: tokens [B, 1], paged cache required
    * chunked paged prefill: tokens [1, C], paged cache, ``chunk`` =
      ``(seq, start)`` — one chunk of sequence ``seq`` at absolute
      positions ``start .. start+C-1`` (see :func:`prefill_paged_chunk`)
    """
    pat = _dense_pattern(cfg)
    period = len(pat)
    plan = plan or PartitionPlan.uniform(cfg.num_layers)
    plan = plan.align_to_period(period, cfg.num_layers)
    plan.validate(cfg.num_layers, period)

    x = embed(params["embed"], tokens,
              plan.embed_policy.precision.compute_dtype)
    dev = tokens.device
    if decode:
        ps = first_paged_state(cache)
        if ps is None:
            raise NotImplementedError("dense-cache decode is not ported yet")
        # every batch slot sits at its own context length; copied because
        # the first layer's append advances these lengths in place
        positions = ps.lengths[0][:, None].clone()
    elif chunk is not None:
        positions = (chunk[1] + torch.arange(x.shape[1], dtype=torch.int32,
                                             device=dev))[None, :]
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=dev).expand(x.shape[:2])

    for seg in plan.segments:
        for i in range(seg.start // period, seg.end // period):
            blk = tree_map(lambda a: a[i], params["layers"])
            blk_cache = (None if cache is None else
                         {key: tree_map(lambda a: a[i], c)
                          for key, c in cache.items()})
            for j in range(period):
                key = f"sub_{j}"
                x = _sublayer_apply(blk[key], cfg, x, positions, seg.policy,
                                    None if blk_cache is None
                                    else blk_cache[key], decode, chunk)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return LMOutput(lm_logits(table, x, plan.head_policy), cache)


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, cache,
                plan: Optional[PartitionPlan] = None, tp: int = 1) -> LMOutput:
    return forward(params, cfg, tokens, plan, tp, cache=cache, decode=True)


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, cache,
            plan: Optional[PartitionPlan] = None, tp: int = 1) -> LMOutput:
    return forward(params, cfg, tokens, plan, tp, cache=cache)


def prefill_paged_chunk(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                        caches, seq: int, start: int,
                        plan: Optional[PartitionPlan] = None,
                        tp: int = 1) -> LMOutput:
    """One chunk of a chunked paged prefill.

    tokens: [1, C] — tokens ``start .. start+C-1`` of sequence ``seq``
    (``start`` and ``C`` block-aligned); ``caches`` is the engine's paged
    cache dict.  The chunk's KV lands directly in the sequence's blocks
    and attention reads the paged prefix back.  Returns logits for the
    chunk (callers use ``logits[:, -1]`` of the final chunk to pick the
    first output token).
    """
    return forward(params, cfg, tokens, plan, tp, cache=caches,
                   chunk=(seq, start))
