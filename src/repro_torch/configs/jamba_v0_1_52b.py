"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

Layer pattern (period 8): one attention layer per 8 (the 1:7 ratio), MoE
MLP on every other layer.  No positional embeddings (rope_theta=0) — the
Mamba layers carry position.  long_500k runs: decode against a 500k
context is O(1)-state for the 28 Mamba layers and linear-per-token for
the 4 attention layers' KV caches (~8.6 GB total in bf16 at KVp=16,
sharded 16-way -> 540 MB/chip).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    rope_theta=0.0,
    mixer="hybrid",
    attn_every=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
    remat=True,
    fsdp=True,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    rope_theta=0.0,
    mixer="hybrid",
    attn_every=8,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, every=2),
    mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
    remat=False,
)
