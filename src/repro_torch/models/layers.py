"""Shared model building blocks (the port of ``repro.models.layers``).

Every matmul routes through :func:`repro_torch.core.quantization.pdot` so
the MPAI precision policy of the enclosing segment applies uniformly.
Norms and rotary phases always run in fp32.  Parameters are f32 masters,
cast (or quantized) at use, as in the reference.

Inside the model group (``core/collectives.py``) the MLP, the embedding,
the LM head and the loss compute on the rank's part: ``w_in`` / ``w_gate``
column-parallel and ``w_out`` row-parallel, the table's rows of the
rank's vocab slice, logits of its vocab columns and a vocab-parallel
cross-entropy that never gathers them.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
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


def layernorm_init(shape, device) -> Dict:
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=device)}


def layernorm(params: Dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Two-pass mean and variance in f32, as the reference writes them."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] \
        + params["bias"]
    return out.to(x.dtype)


def make_norm(norm_type: str):
    if norm_type == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if norm_type == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(norm_type)


def promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands of a product in their common dtype, as ``jnp`` promotes
    them (an f32 activation and a bf16 parameter meet in f32): ``@`` and
    ``einsum`` take no mixed operands.  Operands already of that dtype are
    returned as they are."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return tuple(t.to(dt) for t in ts)


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


class _Logistic(torch.autograd.Function):
    """``lax.logistic``: forward ``1 / (1 + exp(-x))``, backward
    ``g * (s * (1 - s))`` from the output, each step rounded to the dtype
    as JAX's rule computes it (autograd through the forward's three ops
    rounds otherwise, which bf16 gradients show)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference runs it: ``1 / (1 + exp(-x))``
    with every step rounded to ``x``'s dtype (XLA keeps no excess
    precision in bf16), which ``torch.sigmoid``'s single rounding does not
    reproduce; its gradient is JAX's (``_Logistic``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Logistic.apply(x)
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference runs it: ``x * sigmoid(x)``, each
    step rounded as :func:`sigmoid` says."""
    return x * sigmoid(x)


def _const(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (as JAX casts a constant to its operand's
    dtype), as a Python float."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation, its default) as the
    reference runs it: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))``
    with the constants cast to ``x``'s dtype and every op rounded there
    (``x**3`` as ``x * (x * x)``); ``F.gelu`` rounds once from f32."""
    c1 = _const(math.sqrt(2 / math.pi), x.dtype)
    c2 = _const(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * (x * x)))))
    return x * cdf


def mlp_apply(params: Dict, x: torch.Tensor, act: str = "silu",
              glu: bool = True,
              policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    a = silu if act == "silu" else gelu
    h = pdot(x, params["w_in"], policy, split="col")
    if glu:
        h = a(pdot(x, params["w_gate"], policy, split="col")) * h
    else:
        h = a(h)
    return pdot(h, params["w_out"], policy, split="row")


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embedding_init(vocab: int, d_model: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    return dense_init((vocab, d_model), generator, device, 0.02)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of ``tokens``, cast to ``dtype``.  Inside the model group
    ``table`` is the rank's vocab slice: each rank looks up the tokens it
    owns (the others' rows zeroed) and an all-reduce in f32 sums one row
    and zeros, exactly, before the cast; the backward touches only the
    owned rows."""
    # gather the rows first, then cast: the same values as the reference's
    # table.astype(dtype)[tokens] without a bf16 copy of the whole table.
    # F.embedding, not table[tokens]: the gradient of an index is an
    # index_put_ with atomics on the card, embedding's backward sums each
    # row in a fixed order, so a training step repeats bit for bit
    if collectives.model_ranks() == 1:
        return F.embedding(tokens, table).to(dtype)
    vocab = table.shape[0]
    local = tokens - collectives.model_rank() * vocab
    own = (local >= 0) & (local < vocab)
    rows = F.embedding(local.clamp(0, vocab - 1), table).float()
    rows = torch.where(own[..., None], rows, 0.0)
    return collectives.from_model(rows).to(dtype)


def lm_logits(table: torch.Tensor, x: torch.Tensor,
              policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Logits against the (possibly tied) embedding table [V, D]: inside
    the model group, the rank's vocab columns."""
    # a raw product in the policy's compute dtype, whatever its mode
    return pdot(x, table.T, PrecisionPolicy(policy.precision), split="col")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in f32.  The reference takes the gold logit
    as a masked sum over the vocab axis (there it keeps a vocab-sharded
    logits tensor from being gathered); one logit plus zeros is that logit
    exactly, so a gather gives the same value without the [tokens, vocab]
    mask and its gradient (2 x 6.6 GB at StableLM-2's 16,384 tokens x
    100,352).

    Inside the model group ``logits`` are the rank's vocab columns and the
    loss is vocab-parallel: the local max then ``model_max``, the local sum
    of exponentials then an all-reduce, and the gold logit from the rank
    that owns it then an all-reduce; the log-sum-exp then sums in another
    order than ``torch.logsumexp``."""
    logits = logits.float()
    if collectives.model_ranks() == 1:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.mean(lse - gold)
    vocab = logits.shape[-1]
    m = collectives.model_max(logits.detach().amax(dim=-1))
    total = collectives.from_model(
        torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = m + torch.log(total)
    local = labels.long() - collectives.model_rank() * vocab
    own = (local >= 0) & (local < vocab)
    gold = torch.gather(logits, -1, local.clamp(0, vocab - 1)[..., None])
    gold = collectives.from_model(torch.where(own, gold[..., 0], 0.0))
    return torch.mean(lse - gold)
