"""MusicGen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284].

Backbone only: EnCodec tokenization + codebook interleaving are upstream;
the conditioning (text/melody) frontend is a STUB delivering 64
precomputed embeddings.  48L, d=1536, MHA (kv=24), GeLU MLP (no GLU),
vocab 2048 (EnCodec codebook).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    glu=False,
    frontend="audio",
    frontend_tokens=64,
    remat=True,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    act="gelu",
    glu=False,
    frontend="audio",
    frontend_tokens=8,
    remat=False,
)
