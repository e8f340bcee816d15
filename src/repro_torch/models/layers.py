"""Shared model building blocks (the port of ``repro.models.layers``).

Every matmul routes through :func:`repro_torch.core.quantization.pdot` so
the MPAI precision policy of the enclosing segment applies uniformly.
Norms and rotary phases always run in fp32.  Parameters are f32 masters,
cast (or quantized) at use, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.quantization import pdot


def dense_init(shape, generator: torch.Generator, device,
               scale: float) -> torch.Tensor:
    """Normal(0, scale) f32 weights, made on ``device``."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# Norms (always fp32 compute)
# ---------------------------------------------------------------------------
def rmsnorm_init(shape, device) -> Dict:
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] int32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # [D/2]
    angles = positions[..., None].float() * freqs                # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]                        # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------
def mlp_init(n: int, d_model: int, d_ff: int, glu: bool,
             generator: torch.Generator, device) -> Dict:
    """``n`` stacked MLPs (the leading super-block axis)."""
    p = {"w_in": dense_init((n, d_model, d_ff), generator, device,
                            d_model ** -0.5),
         "w_out": dense_init((n, d_ff, d_model), generator, device,
                             d_ff ** -0.5)}
    if glu:
        p["w_gate"] = dense_init((n, d_model, d_ff), generator, device,
                                 d_model ** -0.5)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference runs it: ``x * 1 / (1 + exp(-x))``
    with every step rounded to ``x``'s dtype (XLA keeps no excess
    precision in bf16), which ``F.silu``'s single rounding does not
    reproduce."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_apply(params: Dict, x: torch.Tensor, act: str = "silu",
              glu: bool = True,
              policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    # the reference's jax.nn.gelu is the tanh approximation by default
    a = silu if act == "silu" else functools.partial(F.gelu,
                                                     approximate="tanh")
    h = pdot(x, params["w_in"], policy)
    if glu:
        h = a(pdot(x, params["w_gate"], policy)) * h
    else:
        h = a(h)
    return pdot(h, params["w_out"], policy)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embedding_init(vocab: int, d_model: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    return dense_init((vocab, d_model), generator, device, 0.02)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    # gather the rows first, then cast: the same values as the reference's
    # table.astype(dtype)[tokens] without a bf16 copy of the whole table
    return table[tokens].to(dtype)


def lm_logits(table: torch.Tensor, x: torch.Tensor,
              policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Logits against the (possibly tied) embedding table [V, D]."""
    dt = policy.precision.compute_dtype
    return torch.matmul(x.to(dt), table.to(dt).T)
