"""Shape-and-dtype stand-ins for every cell's inputs, as ``meta`` tensors
(no allocation): the port of ``repro.launch.specs``, whose
``jax.eval_shape`` structs these equal leaf for leaf."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.quantization import QTensor
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as T
from repro_torch.models.frontends import frontend_embeds_spec

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def token_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token positions = seq_len minus the (stub) frontend positions."""
    if cfg.frontend != "none" and shape.kind in ("train", "prefill"):
        return shape.seq_len - cfg.frontend_tokens
    return shape.seq_len


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    b = shape.global_batch
    s = token_len(cfg, shape)
    if shape.kind == "train":
        out = {"tokens": _meta((b, s), torch.int32),
               "labels": _meta((b, s), torch.int32)}
    else:
        out = {"tokens": _meta((b, s), torch.int32)}
    if cfg.frontend != "none" and shape.kind in ("train", "prefill"):
        out["frontend_embeds"] = frontend_embeds_spec(cfg, b)
    return out


def param_structs(cfg: ModelConfig, tp: int, dtype=None):
    """``T.model_init``'s tree at head padding ``tp``; with ``dtype`` every
    floating leaf takes it."""
    shapes = T.model_init(cfg, torch.Generator(), META, tp)
    if dtype is None:
        return shapes
    return tree_map(lambda t: _meta(t.shape, dtype)
                    if t.dtype.is_floating_point else t, shapes)


# dt_proj and the LoRAs stay float (tiny, fp32 math)
QUANTIZABLE = {"wq", "wk", "wv", "wo", "w_in", "w_gate", "w_out",
               "in_proj", "out_proj", "x_proj",
               "w_r", "w_k", "w_v", "w_g", "w_o", "w_kc", "w_vc", "w_rc"}


def param_structs_quantized(cfg: ModelConfig, tp: int):
    """Serving structs with the MPAI int8 deployment: every stacked-layer
    weight matrix is a QTensor (int8 values + per-layer-per-channel f32
    scales); embed/head/norms stay bf16."""
    shapes = param_structs(cfg, tp, torch.bfloat16)

    def q(name, leaf):
        if isinstance(leaf, dict):
            return {k: q(k, v) for k, v in leaf.items()}
        if name in QUANTIZABLE and leaf.ndim >= 3 and \
                leaf.dtype.is_floating_point:
            scale = (leaf.shape[0],) + (1,) * (leaf.ndim - 2) \
                + (leaf.shape[-1],)
            return QTensor(_meta(leaf.shape, torch.int8),
                           _meta(scale, torch.float32))
        return leaf
    shapes["layers"] = q("layers", shapes["layers"])
    return shapes


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, tp: int):
    """The decode cache stacked over super-blocks, as the reference's
    ``init_cache`` gives it: the port's per-super-block recurrent caches
    (lists) become one named tuple of stacked leaves."""
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, tp,
                         device=META)

    def stacked(c):
        if not isinstance(c, list):
            return c
        return type(c[0])(*(None if t is None else
                            _meta((len(c),) + tuple(t.shape), t.dtype)
                            for t in c[0]))
    return {k: stacked(v) for k, v in cache.items()}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, tp: int
                 ) -> Tuple[Dict, object]:
    tok = _meta((shape.global_batch, 1), torch.int32)
    return {"tokens": tok}, cache_structs(cfg, shape, tp)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, tp: int) -> Dict:
    """Everything the cell's step function consumes, as structs."""
    out = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        out["batch"], out["cache"] = decode_specs(cfg, shape, tp)
    return out
