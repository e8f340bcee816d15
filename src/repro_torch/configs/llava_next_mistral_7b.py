"""LLaVA-NeXT (Mistral-7B backbone) — VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone only: the anyres vision tower is a STUB
delivering precomputed patch embeddings (576 = 24x24 base grid) that are
prepended to the token sequence.  Mistral-7B geometry: 32L, GQA kv=8,
SwiGLU 14336, theta 1e6.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e6,
    frontend="vision",
    frontend_tokens=576,
    remat=True,
)

SMOKE = ModelConfig(
    name="llava-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    rope_theta=1e6,
    frontend="vision",
    frontend_tokens=8,
    remat=False,
)
