"""RWKV-6 (Finch) mixer — attention-free, data-dependent per-channel decay
(the port of ``repro.models.rwkv``).

Per head (size N): S_t = diag(w_t) S_{t-1} + k_t v_t^T,
                   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T).

Prefill runs the sequence through the wkv kernel of ``kernels/ops.py``
(the reference runs a chunked associative scan in XLA; the two compute the
same recurrence and sum in different orders).  Decode carries (S,
previous-token activations) and takes one exact step in plain PyTorch, as
the reference has no kernel there.

Dtypes follow the reference op by op: under the bf16 plan the residual
stream is bf16 while the token-shift mixes and decays are f32 arrays, so
a step's result type is what JAX's promotion gives (a bf16 / f32 pair is
f32).  TP padding: heads pad to a multiple of the TP degree with
zero-weight projections; padded heads emit exact zeros.

Inside the model group (``core/collectives.py``) the time mix computes on
the rank's ``Hp / tp`` heads: ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` and the
decay LoRA's ``wB`` are column-parallel (the LoRA's replicated input
through ``to_model``), ``w0``, ``u`` and the per-head group norm are the
rank's channels, wkv runs on the rank's heads and ``w_o`` is
row-parallel; a decode cache holds the rank's state heads.  The channel
mix is column-parallel in ``w_kc`` and row-parallel in ``w_vc``; its
receptance ``w_rc`` is column-parallel over ``d_model``, so ``r`` is
gathered (``model_gather``) before it gates the whole ``v``.  The token
shift, its mixing LoRA and the previous tokens stay replicated.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.core import collectives
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.quantization import pdot
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, promoted, sigmoid, silu


def _padded_heads(cfg: ModelConfig, tp: int) -> int:
    rc = cfg.rwkv or RWKVConfig()
    h = cfg.d_model // rc.head_size
    tp = max(tp, 1)
    return ((h + tp - 1) // tp) * tp


def rwkv_dims(cfg: ModelConfig, tp: int) -> Tuple[int, int, int]:
    rc = cfg.rwkv or RWKVConfig()
    hp = _padded_heads(cfg, tp)
    return hp, rc.head_size, hp * rc.head_size     # Hp, N, Dp


def _local_dims(cfg: ModelConfig, tp: int) -> Tuple[int, int, int]:
    """``rwkv_dims`` of the rank's part: inside the model group its
    ``Hp / tp`` heads and their channels."""
    hp, n, dp = rwkv_dims(cfg, tp)
    ranks = collectives.model_ranks()
    return hp // ranks, n, dp // ranks


def _pad_last(w: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(w, (0, width - w.shape[-1]))


# ---------------------------------------------------------------------------
# Parameters (``n`` stacked mixers, f32, made on ``device``)
# ---------------------------------------------------------------------------
def time_mix_init(cfg: ModelConfig, n: int, generator: torch.Generator,
                  device, tp: int = 1) -> Dict:
    rc = cfg.rwkv or RWKVConfig()
    d = cfg.d_model
    _, _, dp = rwkv_dims(cfg, tp)

    def proj():
        return _pad_last(dense_init((n, d, d), generator, device, d ** -0.5),
                         dp)

    def normal(shape, scale):
        return dense_init(shape, generator, device, scale)

    full = lambda shape, value: torch.full(shape, value, dtype=torch.float32,
                                           device=device)
    w_o = dense_init((n, d, d), generator, device, d ** -0.5)
    w0 = _pad_last(torch.linspace(-6.0, -1.0, d, dtype=torch.float32,
                                  device=device), dp)
    return {
        # ddlerp token-shift mixing
        "mu_x": full((n, d), 0.5),
        "mu": full((n, 5, d), 0.5),
        "mix_A": normal((n, d, 5 * rc.mix_lora), 0.01),
        "mix_B": normal((n, 5, rc.mix_lora, d), 0.01),
        # projections (padded out-dim; w_o padded rows are zero)
        "w_r": proj(), "w_k": proj(), "w_v": proj(), "w_g": proj(),
        "w_o": torch.nn.functional.pad(w_o, (0, 0, 0, dp - d)),
        # data-dependent decay (lora) + bonus
        "w0": w0.expand(n, dp).clone(),
        "wA": normal((n, d, rc.decay_lora), 0.01),
        "wB": normal((n, rc.decay_lora, dp), 0.01),
        "u": normal((n, dp), 0.1),
        # per-head group norm
        "gn_scale": full((n, dp), 1.0),
        "gn_bias": full((n, dp), 0.0),
    }


def channel_mix_init(cfg: ModelConfig, n: int, generator: torch.Generator,
                     device) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    half = torch.full((n, d), 0.5, dtype=torch.float32, device=device)
    return {"mu_k": half, "mu_r": half.clone(),
            "w_kc": dense_init((n, d, f), generator, device, d ** -0.5),
            "w_vc": dense_init((n, f, d), generator, device, f ** -0.5),
            "w_rc": dense_init((n, d, d), generator, device, d ** -0.5)}


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------
class RWKVCache(NamedTuple):
    s: torch.Tensor          # [B, Hp, N, N] wkv state
    x_tmix: torch.Tensor     # [B, D] previous token (time-mix shift)
    x_cmix: torch.Tensor     # [B, D] previous token (channel-mix shift)


def init_rwkv_cache(cfg: ModelConfig, batch: int, tp: int = 1,
                    dtype=torch.float32, device="cuda") -> RWKVCache:
    hp, n, _ = _local_dims(cfg, tp)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return RWKVCache(zeros(batch, hp, n, n), zeros(batch, cfg.d_model),
                     zeros(batch, cfg.d_model))


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------
def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """[x_prev, x_0 .. x_{S-2}] along the sequence, in the promoted dtype
    (``jnp.concatenate`` promotes a bf16 / f32 pair to f32)."""
    dt = torch.promote_types(x.dtype, x_prev.dtype)
    return torch.cat([x_prev[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def _ddlerp(params: Dict, x: torch.Tensor, x_prev: torch.Tensor):
    """RWKV-6 data-dependent token-shift.  x, x_prev: [B, S, D] -> the five
    mixed streams [5, B, S, D] plus the lerp that feeds the mixing lora."""
    xx = x_prev - x
    xxx = x + xx * params["mu_x"]
    lora = torch.tanh(torch.matmul(*promoted(xxx.float(), params["mix_A"])))
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    dyn = torch.einsum("bsli,lid->lbsd", *promoted(lora, params["mix_B"]))
    mixed = x[None] + xx[None] * (params["mu"][:, None, None, :]
                                  + dyn).to(x.dtype)
    return mixed, xxx


def _group_norm(params: Dict, y: torch.Tensor, n: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head layer norm over the padded channel dim (population
    variance, as ``jnp.var``)."""
    shp = y.shape
    yh = y.reshape(*shp[:-1], -1, n).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return yh.reshape(shp) * params["gn_scale"] + params["gn_bias"]


def _decay(params: Dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1), f32, over the padded channels."""
    lora = torch.tanh(torch.matmul(*promoted(xw.float(), params["wA"])))
    # a column-parallel wB: the replicated lora's gradient sums the ranks'
    ww = params["w0"] + torch.matmul(*promoted(collectives.to_model(lora),
                                               params["wB"]))
    return torch.exp(-torch.exp(ww))


def time_mix_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   x_prev: torch.Tensor, tp: int = 1,
                   policy: PrecisionPolicy = DEFAULT_POLICY):
    """x: [B, S, D]; x_prev: [B, D] (the token before this window).
    Returns (out [B, S, D], final state [B, Hp, N, N], last token [B, D])."""
    hp, n, dp = _local_dims(cfg, tp)
    b, s, _ = x.shape
    mixed, _ = _ddlerp(params, x, _shift(x, x_prev))
    xr, xk, xv, xw, xg = mixed.unbind(0)

    def heads(a):
        return a.reshape(b, s, hp, n).float()
    r = heads(pdot(xr, params["w_r"], policy, split="col"))
    k = heads(pdot(xk, params["w_k"], policy, split="col"))
    v = heads(pdot(xv, params["w_v"], policy, split="col"))
    g = silu(pdot(xg, params["w_g"], policy, split="col"))
    w = heads(_decay(params, xw))
    # u meets f32 operands, so a bf16 u is promoted, as in the reference
    y, s_fin = kops.wkv(r, k, v, w, params["u"].reshape(hp, n).float())
    y = _group_norm(params, y.reshape(b, s, dp), n).to(x.dtype) * g
    return pdot(y, params["w_o"], policy, split="row"), s_fin, x[:, -1]


def time_mix_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    cache_s: torch.Tensor, x_prev: torch.Tensor, tp: int = 1,
                    policy: PrecisionPolicy = DEFAULT_POLICY):
    """One token.  x: [B, D].  The exact one-step recurrence, no kernel.
    Returns (out [B, D], new state, x)."""
    hp, n, dp = _local_dims(cfg, tp)
    b = x.shape[0]
    mixed, _ = _ddlerp(params, x[:, None], x_prev[:, None])
    xr, xk, xv, xw, xg = mixed[:, :, 0].unbind(0)

    def heads(a):
        return a.reshape(b, hp, n).float()
    r = heads(pdot(xr, params["w_r"], policy, split="col"))
    k = heads(pdot(xk, params["w_k"], policy, split="col"))
    v = heads(pdot(xv, params["w_v"], policy, split="col"))
    g = silu(pdot(xg, params["w_g"], policy, split="col"))
    w = heads(_decay(params, xw))
    u = params["u"].reshape(hp, n)
    kv = k[..., None] * v[..., None, :]                    # [B, Hp, N, N]
    y = torch.einsum("bhn,bhnm->bhm", r, cache_s + u[None, ..., None] * kv)
    s_new = w[..., None] * cache_s + kv
    y = _group_norm(params, y.reshape(b, dp), n).to(x.dtype) * g
    return pdot(y, params["w_o"], policy, split="row"), s_new, x


def channel_mix_apply(params: Dict, x: torch.Tensor, x_prev: torch.Tensor,
                      policy: PrecisionPolicy = DEFAULT_POLICY):
    """x: [B, S, D]; x_prev: [B, D].  Returns (out, last token)."""
    shifted = _shift(x, x_prev)
    xk = x + (shifted - x) * params["mu_k"]
    xr = x + (shifted - x) * params["mu_r"]
    k = torch.square(torch.relu(pdot(xk, params["w_kc"], policy,
                                     split="col")))
    v = pdot(k, params["w_vc"], policy, split="row")
    # the rank's receptance columns, gathered: ``v`` is whole
    r = collectives.model_gather(pdot(xr, params["w_rc"], policy,
                                      split="col"), -1)
    return sigmoid(r) * v, x[:, -1]


def channel_mix_decode(params: Dict, x: torch.Tensor, x_prev: torch.Tensor,
                       policy: PrecisionPolicy = DEFAULT_POLICY):
    out, _ = channel_mix_apply(params, x[:, None], x_prev, policy)
    return out[:, 0], x
