"""The two-layer dense config the test suites share (``tests/conftest.py``'s
``tiny_dense()``)."""
from repro_torch.configs.base import ModelConfig

TINY = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                   remat=False)
