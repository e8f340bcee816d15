"""StarCoder2-15B — dense, GQA kv=4, sliding-window 4096
[arXiv:2402.19173].

40L, d=6144, 48 heads x 128, plain GeLU MLP (no GLU) 24576, vocab 49152.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    act="gelu",
    glu=False,
    sliding_window=4096,
    rope_theta=100000.0,
    remat=True,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    act="gelu",
    glu=False,
    sliding_window=16,
    remat=False,
)
