"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay
[arXiv:2404.05892].

32L, d=2560 (40 heads x 64; pad to 48 at tp=16), channel-mix hidden 8960,
vocab 65536.  O(1) decode state (wkv matrix per head).
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

FULL = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    mixer="rwkv6",
    rwkv=RWKVConfig(head_size=64, decay_lora=64, mix_lora=32),
    remat=True,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=128,
    vocab_size=512,
    mixer="rwkv6",
    rwkv=RWKVConfig(head_size=16, decay_lora=8, mix_lora=8),
    remat=False,
)
