"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version; ``build.py`` compiles and loads them on first use."""
