"""Llama-3.1 405B — dense, GQA kv=8, 128k vocab [arXiv:2407.21783].

126L, d=16384, 128 heads x 128, SwiGLU 53248, theta 500000.  The memory
stress case: its ``fsdp``, ``remat`` and ``grad_accum`` fields keep the
reference's values, field for field.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
    remat=True,
    remat_group=9,        # sqrt remat over the 126-layer stack (14 x 9)
    fsdp=True,
    grad_accum=8,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    rope_theta=500000.0,
    remat=False,
    fsdp=False,
    grad_accum=2,
)
