"""OLMoE-1B-7B — MoE, 64 experts top-8 on every layer [arXiv:2409.02060].

16L, d=2048, MHA (kv=16), per-expert SwiGLU hidden 1024, vocab 50304.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024, every=1),
    remat=True,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, every=1),
    remat=False,
)
