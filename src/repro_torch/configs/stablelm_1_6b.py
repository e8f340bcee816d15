"""StableLM-2 1.6B — dense, MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b].

24L, d=2048, 32 heads, SwiGLU 5632, vocab 100352.  (Deviation, as in the
reference: upstream uses LayerNorm + partial rope; the framework's RMSNorm
+ full rope stand in.)
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    remat=True,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    remat=False,
)
