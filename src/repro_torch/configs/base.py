"""Configuration dataclasses (the port's copy of ``repro.configs.base``).

Every architecture is described by a frozen :class:`ModelConfig`, field for
field the reference's, so a config means the same model in both packages.
The reference's shape, mesh and training configs belong to later slices.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


# ---------------------------------------------------------------------------
# Mixture-of-Experts
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int                  # hidden dim of each expert MLP
    capacity_factor: float = 1.25
    every: int = 1                    # a MoE MLP every `every` layers (else dense)
    router_dtype: str = "float32"     # routers are accuracy-critical: never quantized
    shared_d_ff: int = 0              # optional shared (always-on) expert hidden dim


# ---------------------------------------------------------------------------
# Mamba / RWKV mixer hyper-parameters
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, math.ceil(d_model / 16))


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64              # rank of the data-dependent decay LoRA
    mix_lora: int = 32                # rank of the token-shift mixing LoRA


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                    # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    act: str = "silu"                 # silu (SwiGLU) | gelu (plain GeLU MLP)
    glu: bool = True
    tie_embeddings: bool = False
    # mixer layout --------------------------------------------------------
    mixer: str = "attention"          # attention | mamba | rwkv6 | hybrid
    attn_every: int = 1               # hybrid: one attention layer per `attn_every`
    sliding_window: int = 0           # 0 = full causal; >0 = windowed attention
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # modality frontend (STUB: input_specs deliver precomputed embeddings) --
    frontend: str = "none"            # none | vision | audio
    frontend_tokens: int = 0          # prepended embedding tokens per sample
    # memory knobs ---------------------------------------------------------
    remat: bool = True
    remat_policy: str = "none"        # none (recompute all) | dots (save dot
    #   outputs: remat recompute skips matmuls AND their TP all-reduces —
    #   trades HBM for collective+compute, §Perf)
    remat_group: int = 0              # >0: sqrt remat — checkpoint groups of
    #   this many super-blocks (outer) on top of per-block remat (inner);
    #   memory ~ (n/G + G) boundaries instead of n, compute ~10ND vs 8ND
    fsdp: bool = False                # 2D (data x model) parameter sharding
    sharding_mode: str = "tp"         # tp | fsdp (pure ZeRO-3, no TP —
    #   beats TP on collective bytes for small dense models, §Perf)
    grad_accum: int = 1               # microbatches per train step
    scan_layers: bool = True          # False: unroll ALL scans (cost probes)
    scan_chunk: int = 0               # SSM/linear-mixer chunk (0 = default)
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 (per-token-per-head
    #   absmax scales; halves the decode-dominant cache traffic — §Perf)

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    # ------------------------------------------------------------------
    # Head padding for tensor parallelism (documented in DESIGN.md §5):
    # head counts that do not divide the TP degree are zero-padded up to
    # the next multiple; kv heads are replicated to lcm(kv, tp).
    # ------------------------------------------------------------------
    def padded_heads(self, tp: int) -> int:
        h = self.num_heads
        return h if h % max(tp, 1) == 0 else ((h + tp - 1) // tp) * tp

    def padded_kv_heads(self, tp: int) -> int:
        kv = self.num_kv_heads
        if tp <= 1 or kv % tp == 0:
            return kv
        return math.lcm(kv, tp)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim()
        n = v * d                                            # embedding
        if not self.tie_embeddings:
            n += v * d                                       # lm head
        for i in range(L):
            kind = self.layer_mixer(i)
            if kind == "attention":
                n += d * (self.num_heads * hd) * 2           # q, o
                n += d * (self.num_kv_heads * hd) * 2        # k, v
            elif kind == "mamba":
                mc = self.mamba or MambaConfig()
                di = mc.expand * d
                n += d * 2 * di + di * d                     # in/out proj
                n += di * mc.d_conv                          # conv
                n += di * (mc.resolved_dt_rank(d) + 2 * mc.d_state)
                n += mc.resolved_dt_rank(d) * di + di * mc.d_state + di
            elif kind == "rwkv6":
                rc = self.rwkv or RWKVConfig()
                n += d * d * 5 + d * d                       # r,k,v,g,o + gate-ish
                n += 2 * (d * rc.decay_lora + rc.decay_lora * d)
            if self.is_moe_layer(i):
                assert self.moe is not None
                e = self.moe
                per = d * e.d_ff_expert * (3 if self.glu else 2)
                n += e.num_experts * per + d * e.num_experts  # experts + router
                if e.shared_d_ff:
                    n += d * e.shared_d_ff * (3 if self.glu else 2)
            else:
                n += d * f * (3 if self.glu else 2)
        return n

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        n = self.param_count()
        e = self.moe
        per = self.d_model * e.d_ff_expert * (3 if self.glu else 2)
        moe_layers = sum(1 for i in range(self.num_layers) if self.is_moe_layer(i))
        n -= moe_layers * (e.num_experts - e.top_k) * per
        return n

    def layer_mixer(self, i: int) -> str:
        if self.mixer == "attention":
            return "attention"
        if self.mixer == "mamba":
            return "mamba"
        if self.mixer == "rwkv6":
            return "rwkv6"
        if self.mixer == "hybrid":
            return "attention" if i % self.attn_every == 0 else "mamba"
        raise ValueError(f"unknown mixer {self.mixer}")

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every == self.moe.every - 1)

    def supports_long_context(self) -> bool:
        """True when the long_500k decode cell is tractable: decode must be
        sub-quadratic in context length.  SSM/linear mixers carry O(1)
        state; hybrids qualify because only 1-in-attn_every layers keep a
        KV cache (linear-per-token decode, cache fits sharded)."""
        return self.mixer in ("mamba", "rwkv6", "hybrid")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
