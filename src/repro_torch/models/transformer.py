"""Model composition (the port of ``repro.models.transformer``: dense
attention, RWKV-6 and hybrid Mamba/attention stacks, with dense or MoE
MLPs).

Layer stacks are built from *super-blocks*, the smallest periodic unit of
the layer pattern (one attention + MLP sublayer for a dense stack; eight
for Jamba's one attention per eight layers with a MoE MLP on every other),
and every parameter carries a leading super-block axis, as in the
reference.  A :class:`~repro_torch.core.partition.PartitionPlan` splits
the stack into contiguous segments; each runs its super-blocks under its
own precision policy.

Training (``loss_fn`` under autograd) recomputes each super-block in the
backward pass when ``cfg.remat``, as the reference's ``jax.checkpoint``
does (``torch.utils.checkpoint``; ``remat_group`` adds the outer groups).

Inside the model group (``core/collectives.py``, entered by the mesh
``Trainer`` and the dry run under ``sharding_mode == "tp"``) the
parameters of attention, dense and MoE MLPs, the embedding and the head
are the rank's parts (``sharding.head_parallel``), and those layers
compute head-, vocab- and expert-parallel; so do Mamba and RWKV-6 mixers,
on the rank's channels and heads (Mamba's ``in_proj`` in the layout
``sharding.TreeSharding.unshard`` gives it), and a decode cache holds the
rank's kv heads and recurrent states.  The logits are then the rank's
vocab columns (the reference's ``logits_spec``) and ``loss_fn``'s
cross-entropy is vocab-parallel.

Inside the layer gather (``core/collectives.py``, entered where a data
axis splits the stacked layers) a stacked leaf so split is the rank's
part, and each super-block reads its leaves through
``collectives.layer_block``: gathered as the forward reaches the block,
again in remat's recompute, its gradient reduced in the backward, as the
reference's scan over FSDP-sharded layers gathers one layer at a time.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwk
from repro_torch.models.layers import (cross_entropy, embed,
                                       embedding_init, lm_logits, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init)
from repro_torch.runtime.paging import PagedKVState

AUX_LOSS_COEF = 0.01


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


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def model_init(cfg: ModelConfig, generator: torch.Generator, device="cuda",
               tp: int = 1) -> Dict:
    """Random f32 parameters in the reference's tree, made on ``device``
    (``generator`` must live there too).  Values differ from the
    reference's ``jax.random`` init; parity tests bridge JAX weights."""
    pat = sublayer_pattern(cfg)
    n = cfg.num_layers // len(pat)
    d = cfg.d_model

    def sublayer(kind, is_moe):
        if kind == "rwkv6":
            mixer = rwk.time_mix_init(cfg, n, generator, device, tp)
        elif kind == "mamba":
            mixer = mam.mamba_init(cfg, n, generator, device)
        else:
            mixer = attn.attention_init(cfg, n, generator, device, tp)
        if kind == "rwkv6":
            mlp = rwk.channel_mix_init(cfg, n, generator, device)
        elif is_moe:
            mlp = moe_mod.moe_init(n, d, cfg.moe, cfg.glu, generator, device)
        else:
            mlp = mlp_init(n, d, cfg.d_ff, cfg.glu, generator, device)
        return {"norm1": rmsnorm_init((n, d), device), "mixer": mixer,
                "norm2": rmsnorm_init((n, d), device), "mlp": mlp}
    layers = {f"sub_{j}": sublayer(kind, is_moe)
              for j, (kind, is_moe) in enumerate(pat)}
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
    """Prefill-target and dense-decode caches, one per sublayer.

    An attention sublayer gets a :class:`~repro_torch.models.attention.
    KVCache` stacked over super-blocks (``[n_super, B, T, KVp, hd]`` k/v,
    bf16 or int8 with f32 scales, and ``pos`` ``[n_super]``; ``T`` is the
    sliding window where there is one); prefill and decode write it in
    place.  A recurrent sublayer (RWKV-6, Mamba) gets a list of ``n_super``
    per-super-block caches, which prefill and decode replace (so their
    dtypes follow the reference's, which change from the f32 zeros of a
    fresh RWKV cache to the residual stream's at the first prefill).  The
    reference broadcasts one cache over the stack; here each super-block
    owns its storage.  Inside the model group every cache holds the
    rank's heads (kv heads, RWKV-6 state heads) or Mamba channels.
    """
    pat = sublayer_pattern(cfg)
    n = cfg.num_layers // len(pat)
    caches = {}
    for j, (kind, _) in enumerate(pat):
        if kind == "rwkv6":
            caches[f"sub_{j}"] = [rwk.init_rwkv_cache(cfg, batch, tp,
                                                      device=device)
                                  for _ in range(n)]
        elif kind == "mamba":
            caches[f"sub_{j}"] = [mam.init_mamba_cache(cfg, batch,
                                                       device=device)
                                  for _ in range(n)]
        else:
            caches[f"sub_{j}"] = attn.init_kv_cache(cfg, batch, max_len, tp,
                                                    lead=(n,), device=device)
    return caches


def cache_position(cfg: ModelConfig, cache) -> torch.Tensor:
    """Current decode position: the first attention cache's ``pos`` (a
    0-d int32 tensor; 0 for a stack without attention caches)."""
    for c in (cache or {}).values():
        if isinstance(c, attn.KVCache):
            return c.pos[0]
    return torch.zeros((), dtype=torch.int32)


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
    """Write the prefill window's k/v (quantized in int8 mode) into one
    layer's dense cache and advance ``pos``, in place (the reference
    returns a new cache)."""
    if cache.quantized:          # one launch: quantize k, v and write
        kops.rowwise_quant_into(k, v, cache.k, cache.v, cache.k_scale,
                                cache.v_scale)
    else:        # s >= t keeps the trailing window, ring-aligned so that
        # position p lands in slot p % t
        kops.write_slots(cache.k, k)
        kops.write_slots(cache.v, v)
    cache.pos.add_(k.shape[1])


def _rwkv_sublayer_apply(sub: Dict, cfg: ModelConfig, x: torch.Tensor,
                         policy: PrecisionPolicy, tp: int,
                         cache: Optional[rwk.RWKVCache], decode: bool):
    """One RWKV-6 time-mix + channel-mix sublayer.  Returns ``(x, new
    cache)`` (None without a cache); decode needs the cache."""
    h = rmsnorm(sub["norm1"], x, cfg.norm_eps)
    if decode:
        y, s_new, x_last = rwk.time_mix_decode(sub["mixer"], cfg, h[:, 0],
                                               cache.s, cache.x_tmix, tp,
                                               policy)
        out = y[:, None]
    else:
        prev = torch.zeros_like(h[:, 0]) if cache is None else cache.x_tmix
        out, s_new, x_last = rwk.time_mix_apply(sub["mixer"], cfg, h, prev,
                                                tp, policy)
    x = x + out
    h2 = rmsnorm(sub["norm2"], x, cfg.norm_eps)
    if decode:
        out2, x_last2 = rwk.channel_mix_decode(sub["mlp"], h2[:, 0],
                                               cache.x_cmix, policy)
        out2 = out2[:, None]
    else:
        prev = torch.zeros_like(h2[:, 0]) if cache is None else cache.x_cmix
        out2, x_last2 = rwk.channel_mix_apply(sub["mlp"], h2, prev, policy)
    new = None if cache is None else rwk.RWKVCache(s_new, x_last, x_last2)
    return x + out2, new


def _mixer_apply(sub: Dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
                 positions: torch.Tensor, policy: PrecisionPolicy, cache,
                 decode: bool, chunk: Optional[Tuple[int, int]]):
    """The attention or Mamba mixer of one sublayer.  Returns ``(out, new
    cache)``: attention caches are written in place and returned as they
    are; a Mamba cache is replaced (None without a cache)."""
    if kind == "mamba":
        if decode:
            return mam.mamba_decode_step(sub["mixer"], cfg, h, cache, policy)
        if cache is None:
            return mam.mamba_apply(sub["mixer"], cfg, h, policy), None
        return mam.mamba_apply(sub["mixer"], cfg, h, policy,
                               return_state=True)
    if decode:
        if isinstance(cache, PagedKVState):
            out = attn.paged_decode_attention_apply(sub["mixer"], cfg, h,
                                                    cache, positions, policy)
        else:
            out = attn.decode_attention_apply(sub["mixer"], cfg, h, cache,
                                              policy)
    elif chunk is not None:
        out = attn.paged_chunk_attention_apply(sub["mixer"], cfg, h, cache,
                                               positions, chunk[0], chunk[1],
                                               policy)
    else:
        out, k, v = attn.attention_apply(sub["mixer"], cfg, h, positions,
                                         policy)
        if cache is not None:
            _prefill_kv(cache, k, v)
    return out, cache


def _sublayer_apply(sub: Dict, cfg: ModelConfig, kind: str, is_moe: bool,
                    x: torch.Tensor, positions: torch.Tensor,
                    policy: PrecisionPolicy, cache=None,
                    decode: bool = False,
                    chunk: Optional[Tuple[int, int]] = None):
    """One attention or Mamba mixer + dense or MoE MLP sublayer.  ``cache``
    is this super-block's view: decode and ``chunk`` (``(seq, start)``,
    chunked paged prefill) take a PagedKVState for attention, dense decode
    a KVCache (or a MambaCache), plain prefill an optional dense cache.
    Returns ``(x, new cache, aux loss)``, the loss None for a dense MLP."""
    h = rmsnorm(sub["norm1"], x, cfg.norm_eps)
    out, new = _mixer_apply(sub, cfg, kind, h, positions, policy, cache,
                            decode, chunk)
    x = x + out
    h2 = rmsnorm(sub["norm2"], x, cfg.norm_eps)
    if is_moe:
        out2, aux = moe_mod.moe_apply(sub["mlp"], cfg.moe, h2, cfg.act,
                                      cfg.glu, policy)
    else:
        out2, aux = mlp_apply(sub["mlp"], h2, cfg.act, cfg.glu, policy), None
    return x + out2, new, aux


class LMOutput(NamedTuple):
    logits: torch.Tensor
    cache: Optional[Dict]
    aux_loss: torch.Tensor        # [] f32: the MoE load-balancing losses


def _block_apply(layers: Dict, cfg: ModelConfig, pat, x: torch.Tensor,
                 i: int, positions: torch.Tensor,
                 policy: PrecisionPolicy, tp: int, cache, decode: bool,
                 chunk: Optional[Tuple[int, int]]):
    """Super-block ``i`` of the stacked ``layers``: every sublayer of the
    pattern in turn.  Returns ``(x, aux)``, aux the sum of the block's MoE
    losses (None without MoE).  Its leaves come through
    ``collectives.layer_block``: gathered there where a data axis splits
    them."""
    aux_total = None
    blk = collectives.layer_block(layers, i)
    for j, (kind, is_moe) in enumerate(pat):
        key = f"sub_{j}"
        c = None if cache is None else cache[key]
        if kind == "rwkv6":
            x, new = _rwkv_sublayer_apply(
                blk[key], cfg, x, policy, tp,
                None if c is None else c[i], decode)
            if c is not None:
                c[i] = new
            continue
        if kind == "mamba":
            view = None if c is None else c[i]
        else:
            view = None if c is None else tree_map(lambda a: a[i], c)
        x, new, aux = _sublayer_apply(blk[key], cfg, kind, is_moe, x,
                                      positions, policy, view, decode, chunk)
        if kind == "mamba" and c is not None:
            c[i] = new
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


def _remat_blocks(block, lo: int, hi: int, x: torch.Tensor, group: int):
    """Super-blocks ``lo .. hi-1`` with each one's activations recomputed
    in the backward pass (the reference's ``jax.checkpoint``); with
    ``group`` dividing their count, groups of ``group`` blocks are
    checkpointed again on top (sqrt remat).  Returns ``(x, aux)``."""
    def run(x, i):
        return checkpoint(block, x, i, use_reentrant=False)

    def run_group(x, g0):
        return _sum_blocks(run, range(g0, g0 + group), x)

    n = hi - lo
    if group and n % group == 0 and n >= group:
        return _sum_blocks(
            lambda x, g0: checkpoint(run_group, x, g0, use_reentrant=False),
            range(lo, hi, group), x)
    return _sum_blocks(run, range(lo, hi), x)


def _sum_blocks(run, indices, x: torch.Tensor):
    """``x`` through ``run(x, i)`` for each ``i`` in turn; returns ``(x,
    the sum of the auxiliary losses, None if there were none)``."""
    aux = None
    for i in indices:
        x, a = run(x, i)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def slice_stack(tree, lo: int, hi: int):
    """Super-blocks ``lo .. hi-1`` of a stacked tree, as views of its
    storage (the reference's ``_slice_stack`` copies)."""
    return tree_map(lambda a: a[lo:hi], tree)


def segment_apply(layers: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: Optional[torch.Tensor],
                  policy: PrecisionPolicy, tp: int = 1,
                  span: Optional[Tuple[int, int]] = None, cache=None,
                  decode: bool = False,
                  chunk: Optional[Tuple[int, int]] = None,
                  remat: bool = False):
    """``x`` through super-blocks ``span = (lo, hi)`` of the stacked
    ``layers`` (all of them when None) under ``policy``: one segment of a
    :class:`PartitionPlan`, the reference's ``_segment_scan``.  ``cache``
    is indexed by absolute super-block.  Returns ``(x, aux)``, aux the sum
    of the MoE losses (None without MoE)."""
    pat = sublayer_pattern(cfg)
    lo, hi = span or (0, tree_leaves(layers)[0].shape[0])
    block = functools.partial(_block_apply, layers, cfg, pat,
                              positions=positions, policy=policy, tp=tp,
                              cache=cache, decode=decode, chunk=chunk)
    if remat:
        return _remat_blocks(block, lo, hi, x, cfg.remat_group)
    return _sum_blocks(block, range(lo, hi), x)


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            plan: Optional[PartitionPlan] = None, tp: int = 1,
            cache=None, decode: bool = False,
            frontend_embeds: Optional[torch.Tensor] = None,
            chunk: Optional[Tuple[int, int]] = None) -> LMOutput:
    """Unified forward; caches are updated in place and returned.

    * train/prefill: tokens [B, S], cache None or a prefill-target cache
      (:func:`init_cache`); ``frontend_embeds`` [B, F, D] (a vision or
      audio frontend's output) go before the token embeddings
    * decode: tokens [B, 1]; a paged cache (attention-only stacks, the
      engine) or the prefilled :func:`init_cache` (the windowed loop)
    * chunked paged prefill: tokens [1, C], paged cache, ``chunk`` =
      ``(seq, start)`` — one chunk of sequence ``seq`` at absolute
      positions ``start .. start+C-1`` (see :func:`prefill_paged_chunk`)

    Under autograd without a cache, ``cfg.remat`` recomputes each
    super-block in the backward pass.  Inside the model group the logits
    are the rank's vocab columns (module docstring).  The reference's ``remat_policy=
    "dots"`` (keep the matmul outputs) is not copied: it changes no value,
    only what is kept, and here every super-block is recomputed whole.
    """
    pat = sublayer_pattern(cfg)
    period = len(pat)
    plan = plan or PartitionPlan.uniform(cfg.num_layers)
    plan = plan.align_to_period(period, cfg.num_layers)
    plan.validate(cfg.num_layers, period)

    x = embed(params["embed"], tokens,
              plan.embed_policy.precision.compute_dtype)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    dev = tokens.device
    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        ps = first_paged_state(cache)
        # copied: the first layer's write advances these in place
        if ps is not None:
            # every batch slot sits at its own context length
            positions = ps.lengths[0][:, None].clone()
        elif any(isinstance(c, attn.KVCache) for c in cache.values()):
            positions = cache_position(cfg, cache).expand(x.shape[0],
                                                          1).clone()
        else:
            positions = None          # recurrent state carries no positions
    elif chunk is not None:
        positions = (chunk[1] + torch.arange(x.shape[1], dtype=torch.int32,
                                             device=dev))[None, :]
    else:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=dev).expand(x.shape[:2])

    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for seg in plan.segments:
        x, aux = segment_apply(params["layers"], cfg, x, positions,
                               seg.policy, tp,
                               (seg.start // period, seg.end // period),
                               cache, decode, chunk, remat)
        if aux is not None:
            aux_total = aux_total + aux

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return LMOutput(lm_logits(table, x, plan.head_policy), cache, aux_total)


def loss_fn(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, plan: Optional[PartitionPlan] = None,
            tp: int = 1,
            frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy plus ``AUX_LOSS_COEF`` times the MoE
    load-balancing losses; the frontend positions carry no loss.
    Differentiable on CPU tensors and on the card, through the backward
    kernels of flash attention, wkv and the selective scan.  Inside the
    model group the loss is vocab-parallel and the same on every rank."""
    out = forward(params, cfg, tokens, plan, tp,
                  frontend_embeds=frontend_embeds)
    logits = out.logits[:, -tokens.shape[1]:]   # skip frontend positions
    return cross_entropy(logits, labels) + AUX_LOSS_COEF * out.aux_loss


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, cache,
                plan: Optional[PartitionPlan] = None, tp: int = 1) -> LMOutput:
    return forward(params, cfg, tokens, plan, tp, cache=cache, decode=True)


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, cache,
            plan: Optional[PartitionPlan] = None, tp: int = 1,
            frontend_embeds: Optional[torch.Tensor] = None) -> LMOutput:
    return forward(params, cfg, tokens, plan, tp, cache=cache,
                   frontend_embeds=frontend_embeds)


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
