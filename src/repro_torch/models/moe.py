"""Token-choice top-k Mixture-of-Experts with capacity-bounded scatter
dispatch (the port of ``repro.models.moe``).

Slot indices come from a cumulative sum over the flattened top-k
assignments, token embeddings are scattered into a dense ``[E, C, D]``
buffer, experts run as one batched einsum, and outputs gather back with
their gate weights.  Small batches (``t * k <= 4096``: decode, short
prefills) use one flat dropless buffer; larger ones a buffer per batch row
whose capacity drops overflowing tokens (Switch/GShard semantics).

On a mesh step that splits the batch (``core/collectives.py``'s batch
group) the rank routes its own rows as the reference routes them inside
the global batch: the path is chosen on the global token count, a row's
capacity and slots are its own in the per-row path and nothing is dropped
in the flat one, and the load-balancing loss takes its assignment counts
and mean probabilities over the group.

Inside the model group (``core/collectives.py``) the experts are
expert-parallel: a rank holds ``E / tp`` of them.  The router stays
replicated, so routing, slots, capacity and the load-balancing loss come
out identical on every rank; the rank runs its experts on its slice of
the dispatch buffer, all-gathers their outputs over the expert dim and
combines as one device does, so the forward is one device's, bit for bit
where the experts' products are.  The dispatch input goes through
``to_model``: the gradient a rank's experts give it is all-reduced.

Routers run in f32 and are never quantized.  The expert products are bf16
einsums in the policy's compute dtype, as in the reference (XLA code
there, not a Pallas kernel), so ``"mpai"`` leaves them unquantized; a
fake-quant (QAT) policy rounds the expert weights and the dispatch buffer
through the int8 grid first, with a straight-through gradient.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import collectives
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.quantization import QTensor, fake_quant
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init, silu

FLAT_DISPATCH_MAX = 4096       # t * k at or below: flat dropless dispatch


def moe_init(n: int, d_model: int, moe: MoEConfig, glu: bool,
             generator: torch.Generator, device) -> Dict:
    """``n`` stacked MoE MLPs, f32, made on ``device``."""
    e, f = moe.num_experts, moe.d_ff_expert
    p = {"router": dense_init((n, d_model, e), generator, device, 0.02),
         "w_in": dense_init((n, e, d_model, f), generator, device,
                            d_model ** -0.5),
         "w_out": dense_init((n, e, f, d_model), generator, device,
                             f ** -0.5)}
    if glu:
        p["w_gate"] = dense_init((n, e, d_model, f), generator, device,
                                 d_model ** -0.5)
    if moe.shared_d_ff:
        p["shared"] = mlp_init(n, d_model, moe.shared_d_ff, glu, generator,
                               device)
    return p


def _expert_ffn(params: Dict, buf: torch.Tensor, act: str, glu: bool,
                policy: PrecisionPolicy) -> torch.Tensor:
    """buf: [E, C, D] or [G, E, C, D] -> same, through each expert's MLP.
    Inside the model group ``params`` and ``buf`` hold the rank's experts,
    and the fake-quant scales span every rank's (``model_max``)."""
    a = silu if act == "silu" else functools.partial(F.gelu,
                                                     approximate="tanh")
    dt = policy.precision.compute_dtype
    dq = lambda w: w.dequantize(dt) if isinstance(w, QTensor) else w
    w_in, w_out = dq(params["w_in"]), dq(params["w_out"])
    w_gate = dq(params["w_gate"]) if "w_gate" in params else None
    if policy.mode == "fake":
        # one scale per output column across all experts, as the reference
        split = collectives.model_ranks() > 1
        w_in = fake_quant(w_in, channel_axis=-1, split=split)
        w_out = fake_quant(w_out, channel_axis=-1, split=split)
        if w_gate is not None:
            w_gate = fake_quant(w_gate, channel_axis=-1, split=split)
        buf = fake_quant(buf, activation=True, split=split)
    bufc = buf.to(dt)
    g = "g" if buf.ndim == 4 else ""
    h = torch.einsum(f"{g}ecd,edf->{g}ecf", bufc, w_in.to(dt))
    if w_gate is not None:
        h = a(torch.einsum(f"{g}ecd,edf->{g}ecf", bufc, w_gate.to(dt))) * h
    else:
        h = a(h)
    return torch.einsum(f"{g}ecf,efd->{g}ecd", h, w_out.to(dt))


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                torch.Tensor]:
    """Each token's ``k`` largest router probabilities and their experts,
    largest first (``probs``: [T, E])."""
    return torch.topk(probs, k, dim=-1)


def _experts(params: Dict, buf: torch.Tensor, dim: int, act: str,
             glu: bool, policy: PrecisionPolicy) -> torch.Tensor:
    """Every expert's output for the dispatch buffer ``buf``, whose expert
    dim is ``dim``: inside the model group the rank's experts run on its
    slice and the outputs are all-gathered (module docstring)."""
    ranks = collectives.model_ranks()
    if ranks == 1:
        return _expert_ffn(params, buf, act, glu, policy)
    n = buf.shape[dim] // ranks
    mine = buf.narrow(dim, collectives.model_rank() * n, n)
    return collectives.model_gather(
        _expert_ffn(params, mine, act, glu, policy), dim)


def moe_apply(params: Dict, moe: MoEConfig, x: torch.Tensor,
              act: str = "silu", glu: bool = True,
              policy: PrecisionPolicy = DEFAULT_POLICY
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux_loss []): the load-balancing
    loss, E * sum(fraction of assignments * mean router probability)."""
    b, s, d = x.shape
    t, k, e = b * s, moe.top_k, moe.num_experts
    xf = x.reshape(t, d)

    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                        # [T, E]
    gate, expert_ids = route(probs, k)                           # [T, k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # the assignment fractions and mean probabilities of the global batch,
    # in one all-reduce: every rank holds the same number of rows
    ranks = collectives.batch_ranks()
    m = collectives.batch_sum(torch.cat([
        F.one_hot(expert_ids, e).float().mean(dim=(0, 1)),
        probs.mean(dim=0)])) / ranks
    aux = e * torch.sum(m[:e] * m[e:])
    xd = collectives.to_model(xf)           # what the experts see of x

    if t * ranks * k <= FLAT_DISPATCH_MAX:
        # decode / small batches: flat dropless dispatch
        cap = t * k
        flat_e = expert_ids.reshape(t * k)                       # token-major
        onehot = F.one_hot(flat_e, e)
        slot = (torch.cumsum(onehot, dim=0) - onehot)[
            torch.arange(t * k, device=x.device), flat_e]
        x_rep = xd[:, None].expand(t, k, d).reshape(t * k, d)    # [T*k, D]
        buf = torch.zeros((e, cap, d), dtype=xf.dtype, device=x.device)
        buf.index_put_((flat_e, slot), x_rep, accumulate=True)
        out_buf = _experts(params, buf, 0, act, glu, policy)     # [E, C, D]
        gathered = out_buf[flat_e, slot]
        gathered = gathered * gate.reshape(t * k, 1).to(gathered.dtype)
        out = gathered.reshape(t, k, d).sum(dim=1)
    else:
        # a capacity buffer per batch row; slots past it are dropped
        sk = s * k
        cap = max(1, int(k * s * moe.capacity_factor / e))
        eids = expert_ids.reshape(b, sk)                         # [B, S*k]
        onehot = F.one_hot(eids, e)                              # [B, S*k, E]
        pos = torch.cumsum(onehot, dim=1) - onehot
        slot = torch.gather(pos, -1, eids[..., None])[..., 0]    # [B, S*k]
        keep = slot < cap
        xr = x if xd is xf else xd.view(b, s, d)   # one device: as before
        x_rep = xr[:, :, None].expand(b, s, k, d).reshape(b, sk, d)
        b_idx = torch.arange(b, device=x.device)[:, None].expand(b, sk)
        # the reference's scatter drops out-of-range writes, torch would
        # raise on them: dropped slots write a spare row past the buffer,
        # which the experts never see (no boolean mask, so no shape that
        # depends on the data and no wait for the host)
        rows = b * e * cap
        dest = torch.where(keep, (b_idx * e + eids) * cap + slot, rows)
        flat = torch.zeros((rows + 1, d), dtype=xf.dtype, device=x.device)
        flat.index_put_((dest.reshape(-1),), x_rep.reshape(-1, d),
                        accumulate=True)
        buf = flat[:rows].view(b, e, cap, d)
        out_buf = _experts(params, buf, 1, act, glu, policy)     # [B,E,C,D]
        gathered = torch.where(
            keep[..., None],
            out_buf.reshape(rows, d)[dest.clamp(max=rows - 1)], 0)  # fill 0
        w = (gate.reshape(b, sk, 1) * keep[..., None]).to(gathered.dtype)
        out = (gathered * w).reshape(b, s, k, d).sum(dim=2).reshape(t, d)

    if "shared" in params:
        out = out + mlp_apply(params["shared"], xf, act, glu, policy)
    return out.reshape(b, s, d).to(x.dtype), aux
