"""Moonlight-16B-A3B (Moonshot) — MoE, 64 experts top-6 + shared experts
[hf:moonshotai/Moonlight-16B-A3B].

48L, d=2048, MHA (kv=16), per-expert SwiGLU hidden 1408, 2 shared experts
(always-on, 2816 combined hidden), vocab 163840.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, every=1,
                  shared_d_ff=2816),
    remat=True,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, every=1,
                  shared_d_ff=128),
    remat=False,
)
