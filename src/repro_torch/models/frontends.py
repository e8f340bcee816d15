"""Modality frontends — STUBS, as in the reference (the port of
``repro.models.frontends``).

``[vlm]`` / ``[audio]`` entries specify the transformer backbone only; the
modality frontend delivers *precomputed* frame/patch embeddings.  These
helpers produce (a) ``meta`` tensors of their shape for dry-runs and (b)
deterministic synthetic embeddings, the reference's bit for bit up to
``prng.normal``'s ulps (within one bf16 ulp after the cast).

llava-next: anyres tiling yields a variable number of patch embeddings; we
fix it at ``frontend_tokens`` (the base 576-patch grid for smoke configs).
musicgen: EnCodec frames arrive as embeddings over the 2048-entry codebook
vocabulary; token interleaving across codebooks is upstream of the backbone.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng


def frontend_embed_shape(cfg: ModelConfig, batch: int):
    return (batch, cfg.frontend_tokens, cfg.d_model)


def frontend_embeds_spec(cfg: ModelConfig, batch: int,
                         dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(frontend_embed_shape(cfg, batch), dtype=dtype,
                       device="meta")


def synthetic_frontend_embeds(cfg: ModelConfig, batch: int, seed: int = 0,
                              dtype=torch.bfloat16,
                              device="cuda") -> torch.Tensor:
    """``normal(PRNGKey(seed), shape) * 0.02`` in float32, cast to
    ``dtype``, made on ``device``."""
    key = prng.threefry_seed(torch.full((), seed, dtype=torch.int64,
                                        device=device))
    return (prng.normal(key, frontend_embed_shape(cfg, batch))
            * 0.02).to(dtype)
