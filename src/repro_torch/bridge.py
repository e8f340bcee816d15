"""Numpy parameter trees -> the port's tensors.

Takes what the JAX reference's ``model_init`` returns after
``jax.tree.map(np.asarray, ...)``: nested dicts (and lists or tuples) of
numpy arrays, with ``QTensor`` leaves kept as named tuples of
``(values, scale)``.  bfloat16 arrays (ml_dtypes) keep their bits.  This is
how every parity test hands the same weights to both packages; it imports
neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import QTensor


def to_tensor(a, device="cuda") -> torch.Tensor:
    a = np.array(a)                          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":           # ml_dtypes: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(tree, device="cuda"):
    """Convert a numpy tree to tensors on ``device`` (the card unless the
    caller asks for the CPU), leaf for leaf."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == (
            "values", "scale"):
        return QTensor(to_tensor(tree.values, device),
                       to_tensor(tree.scale, device))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return to_tensor(tree, device)
