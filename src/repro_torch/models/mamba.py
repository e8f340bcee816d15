"""Mamba-1 selective SSM mixer, Jamba's majority layer (the port of
``repro.models.mamba``).

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t   (per channel, N states)
    y_t = C_t . h_t + D * x_t

Prefill runs the sequence through the selective-scan kernel of
``kernels/ops.py`` (the reference runs a chunked associative scan in XLA;
the two compute the same recurrence and sum in different orders), which
also returns the final state for the decode cache.  Decode takes one exact
step in plain PyTorch, as the reference has no kernel there.  The conv taps
keep the reference's forms: a sum in tap order at prefill, an einsum at
decode.

Inside the model group (``core/collectives.py``) the mixer computes on the
rank's ``d_inner / tp`` channels: ``in_proj`` is column-parallel and comes
in the compute layout ``[x_r | z_r]``, the rank's channels of both halves
(``sharding.TreeSharding.unshard``; it is stored as the reference splits
it), the conv taps, ``dt_bias``, ``A_log`` and ``D`` are the rank's
channels, the scan runs on them, ``x_proj`` and ``out_proj`` are
row-parallel and ``dt_proj`` column-parallel.  ``dt_r``, ``B`` and ``C`` are replicated and
feed every rank's channels, so their gradient sums over the ranks
(``to_model``); a decode cache holds the rank's channels.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.core import collectives
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.quantization import pdot
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, promoted, silu


def _dims(cfg: ModelConfig) -> Tuple[MambaConfig, int, int, int]:
    mc = cfg.mamba or MambaConfig()
    return (mc, mc.expand * cfg.d_model, mc.d_state,
            mc.resolved_dt_rank(cfg.d_model))


def _local_channels(cfg: ModelConfig) -> int:
    """The rank's ``d_inner`` channels (all of them outside a group)."""
    return _dims(cfg)[1] // collectives.model_ranks()


def mamba_init(cfg: ModelConfig, n: int, generator: torch.Generator,
               device) -> Dict:
    """``n`` stacked Mamba mixers, f32, made on ``device``."""
    mc, di, ns, r = _dims(cfg)
    d = cfg.d_model
    # softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((n, di), generator=generator, device=device)
                   * (hi - lo) + lo)
    a_log = torch.log(torch.arange(1, ns + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init((n, d, 2 * di), generator, device, d ** -0.5),
        "conv_w": dense_init((n, mc.d_conv, di), generator, device, 0.1),
        "conv_b": torch.zeros((n, di), dtype=torch.float32, device=device),
        "x_proj": dense_init((n, di, r + 2 * ns), generator, device,
                             di ** -0.5),
        "dt_proj": dense_init((n, r, di), generator, device, r ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": a_log.expand(n, di, ns).clone(),
        "D": torch.ones((n, di), dtype=torch.float32, device=device),
        "out_proj": dense_init((n, di, d), generator, device, di ** -0.5),
    }


class MambaCache(NamedTuple):
    h: torch.Tensor          # [B, d_inner, N]
    conv: torch.Tensor       # [B, d_conv-1, d_inner]: trailing inputs


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     device="cuda") -> MambaCache:
    """A fresh f32 cache (the reference's default dtype), of the rank's
    channels inside the model group."""
    mc, _, ns, _ = _dims(cfg)
    di = _local_channels(cfg)
    return MambaCache(
        torch.zeros((batch, di, ns), dtype=torch.float32, device=device),
        torch.zeros((batch, mc.d_conv - 1, di), dtype=torch.float32,
                    device=device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as written; the f32 exp
    and log1p of the two libraries still differ in the last bit."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(params: Dict, cfg: ModelConfig, xc: torch.Tensor,
                policy: PrecisionPolicy):
    """xc: [B, L, di] (post-conv) -> dt, B_t, C_t (f32, selective)."""
    _, _, ns, r = _dims(cfg)
    proj = pdot(xc, params["x_proj"], policy, split="row").float()
    # replicated and read by the rank's channels alone: the gradient sums
    # over the ranks (in f32, then rounded once by the cast's backward)
    proj = collectives.to_model(proj)
    dt_r, b_t, c_t = torch.split(proj, [r, ns, ns], dim=-1)
    dt = _softplus(dt_r @ params["dt_proj"].float() + params["dt_bias"])
    return dt, b_t, c_t                       # [B,L,di], [B,L,N], [B,L,N]


def mamba_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                policy: PrecisionPolicy = DEFAULT_POLICY,
                return_state: bool = False):
    """Full-sequence mixer from a zero state.  x: [B, S, D] -> [B, S, D]
    (and the :class:`MambaCache` the sequence leaves, with
    ``return_state``)."""
    mc = cfg.mamba or MambaConfig()
    s = x.shape[1]
    xz = pdot(x, params["in_proj"], policy, split="col")
    xr, z = torch.chunk(xz, 2, dim=-1)

    # depthwise causal conv over the sequence, taps summed in order
    xp = torch.nn.functional.pad(xr, (0, 0, mc.d_conv - 1, 0))
    xc = sum(xp[:, i:i + s] * params["conv_w"][i] for i in range(mc.d_conv))
    xc = silu(xc + params["conv_b"]).to(x.dtype)

    dt, b_t, c_t = _ssm_params(params, cfg, xc, policy)
    a = -torch.exp(params["A_log"])                     # [di, N]
    xcf = xc.float()
    # A and D meet f32 operands: bf16 ones are promoted, as in the reference
    y, h_fin = kops.selective_scan(xcf, dt, b_t, c_t, a.float(),
                                   params["D"].float())
    y = y.to(x.dtype) * silu(z)
    out = pdot(y, params["out_proj"], policy, split="row")
    if return_state:
        conv_tail = xr[:, -(mc.d_conv - 1):].float()
        return out, MambaCache(h_fin, conv_tail)
    return out


def mamba_decode_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: MambaCache,
                      policy: PrecisionPolicy = DEFAULT_POLICY
                      ) -> Tuple[torch.Tensor, MambaCache]:
    """One-token step.  x: [B, 1, D] -> ([B, 1, D], new cache)."""
    xz = pdot(x[:, 0], params["in_proj"], policy, split="col")  # [B, 2*di]
    xr, z = torch.chunk(xz, 2, dim=-1)

    hist = torch.cat([cache.conv, xr[:, None].to(cache.conv.dtype)], dim=1)
    xc = torch.einsum("bkd,kd->bd", *promoted(hist, params["conv_w"])) \
        + params["conv_b"]
    xc = silu(xc).to(x.dtype)

    dt, b_t, c_t = _ssm_params(params, cfg, xc[:, None], policy)
    dt, b_t, c_t = dt[:, 0], b_t[:, 0], c_t[:, 0]
    a = -torch.exp(params["A_log"])
    a_bar = torch.exp(dt[..., None] * a)                 # [B,di,N]
    xcf = xc.float()
    h = a_bar * cache.h + (dt * xcf)[..., None] * b_t[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t) + xcf * params["D"]
    y = (y.to(x.dtype) * silu(z))[:, None]
    return (pdot(y, params["out_proj"], policy, split="row"),
            MambaCache(h, hist[:, 1:]))
