"""PyTorch port of ``repro`` for NVIDIA Hopper.

The package mirrors ``repro``'s module layout (``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``) and imports nothing of
``repro`` or JAX.  Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""
