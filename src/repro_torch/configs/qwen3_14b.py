"""Qwen3-14B — dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B family].

40L, d=5120, 40 heads x head_dim 128 (heads pad 40->48 at tp=16;
DESIGN.md §5), SwiGLU 17408, 151936 vocab, theta 1e6, RMSNorm on q/k per
head (the qk_norm flag).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    remat=True,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    rope_theta=1e6,
    remat=False,
)
