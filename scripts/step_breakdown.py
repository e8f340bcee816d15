#!/usr/bin/env python3
"""Where a full-occupancy decode step of the PyTorch port goes, on one card.

    python3 scripts/step_breakdown.py

Serves Qwen3-14B at full width (random weights from seed 0) through
``ContinuousBatchingEngine`` with all 8 slots live, then RWKV-6 3B at full
width and depth and Jamba-v0.1 at full width, one 8-layer super-block
deep, through the windowed server (``engine_or_windowed``'s fallback) with
a window of 8 live requests, each under the ``"mpai"`` plan and then the
bf16 plan, and prints one JSON line per (config, plan):

- ``step_ms``: wall time of one engine decode step (host and device);
- ``device_step_ms``: device time of the same decode step, captured once
  in a CUDA graph on a copy of the engine's live caches and replayed, so
  no host time sits between its kernels;
- ``idle_share``: ``1 - device_step_ms / step_ms``, the share of a step in
  which the card waits on the host;
- ``enqueue_ms`` / ``enqueue_and_run_ms``: host time to issue one eager
  decode step, against the time to issue and finish it;
- ``parts_ms``: device time of each part of the step, each captured alone
  in a CUDA graph at the step's shapes (M = slots) with the 50 MB L2
  flushed before each replay, times its count per step: the per-call
  weight conversion ``pdot`` does (quantize for int8 segments, bf16 cast
  for bf16 ones), the activation quantize, the GEMMs, the paged attention
  kernel on the live caches (Qwen3), the one-step wkv recurrence (RWKV),
  or (Jamba) the seven Mamba layers' one-step recurrences, the four MoE
  layers' expert weight casts and expert einsums, and the attention
  layer's dense-cache decode attention; and the lm head.
  ``other_device_ms`` is the rest of ``device_step_ms``: norms, rope,
  epilogues, KV appends (Qwen3); token-shift mixes, decay and mixing
  loras, group norm, gates (RWKV); the Mamba convs, ``dt`` projections and
  gates, routers and dispatch (Jamba);
- ``beside_step_ms`` (Qwen3): device time, timed the same way, of what a
  sampled or a hardened engine step runs beside the greedy step above:
  the greedy ``argmax`` over the step's 8 rows of bf16 logits, the
  ``sample_logits`` that replaces it when a live row samples (half the
  rows with top_k 50), and the whole KV pool's per-block checksums
  (``pool_checksums`` over every sublayer) a hardened step adds.

Needs one card with 80 GB; builds the port's kernels on first use.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


class GraphTimer:
    """Median device time of ``fn`` captured in a CUDA graph, over
    ``reps`` replays, each after a write of 128 MB that evicts the L2."""

    def __init__(self, device):
        self.scrub = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=device)

    def ms(self, fn, reps: int = 10, scrub: bool = True) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm-up before capture
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            if scrub:
                self.scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        del graph
        torch.cuda.empty_cache()            # the graph's private pool
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def weight_parts(ws, m: int, cfg, plan, timer, dev) -> dict:
    """Device ms per step of what ``pdot`` does with each weight in ``ws``
    (one super-block's matrices) at M = ``m`` rows, times the super-blocks
    of each precision: quantize or cast at use, activation quantize, the
    GEMM."""
    from repro_torch.core.quantization import quantize
    from repro_torch.kernels.ops import int8_matmul

    from repro_torch.models import transformer as T

    # ``ws`` are one super-block's matrices
    period = T.pattern_period(cfg)
    if plan is not None:                # as forward runs it
        plan = plan.align_to_period(period, cfg.num_layers)
    n_int8 = sum(s.num_layers for s in (plan.segments if plan else ())
                 if s.policy.mode == "quant") // period
    n_bf16 = cfg.num_layers // period - n_int8
    parts = {}
    if n_int8:
        conv = gemm = actq = 0.0
        for w in ws:
            x = torch.randn((m, w.shape[0]), device=dev).bfloat16()
            xq, wq = quantize(x), quantize(w, channel_axis=-1)
            conv += timer.ms(lambda: quantize(w, channel_axis=-1))
            actq += timer.ms(lambda: quantize(x))
            gemm += timer.ms(lambda: int8_matmul(xq.values, wq.values))
        parts.update(int8_weight_quantize=n_int8 * conv,
                     int8_activation_quantize=n_int8 * actq,
                     int8_gemm=n_int8 * gemm)
    if n_bf16:
        conv = gemm = 0.0
        for w in ws:
            x = torch.randn((m, w.shape[0]), device=dev).bfloat16()
            wb = w.bfloat16()
            conv += timer.ms(lambda: w.to(torch.bfloat16))
            gemm += timer.ms(lambda: torch.matmul(x, wb))
        parts.update(bf16_weight_cast=n_bf16 * conv, bf16_gemm=n_bf16 * gemm)
    return parts


def host_split(fn) -> tuple:
    """Median host ms to enqueue ``fn``, and to enqueue and finish it."""
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
    return (float(np.median([h[0] for h in host])),
            float(np.median([h[1] for h in host])))


def report(cfg, name: str, card: str, m: int, step_ms: float,
           device_step_ms: float, host: tuple, parts: dict,
           beside: Optional[dict] = None) -> None:
    print(json.dumps({
        "phase": "step_breakdown", "config": cfg.name, "plan": name,
        "card": card, "slots": m, "step_ms": step_ms,
        "device_step_ms": device_step_ms,
        "idle_share": 1 - device_step_ms / step_ms,
        "enqueue_ms": host[0], "enqueue_and_run_ms": host[1],
        "parts_ms": parts,
        "other_device_ms": device_step_ms - sum(parts.values()),
        **({} if beside is None else {"beside_step_ms": beside})}),
        flush=True)


def breakdown(params, cfg, plan, name: str, card: str, timer, dev) -> None:
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import lm_logits
    from repro_torch.runtime.sampling import sample_logits
    from repro_torch.runtime.serve import ContinuousBatchingEngine, Request

    eng = ContinuousBatchingEngine(params, cfg, plan=plan, device=dev,
                                   max_slots=8, prompt_len=32, max_len=128,
                                   block_size=16)
    m = eng.max_slots
    rng = np.random.default_rng(4)
    for i in range(m):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 16)
                           .astype(np.int32), max_new=40))
    eng.step()                          # admits every slot, one decode step
    eng.step()
    torch.cuda.synchronize()
    steps0, reps = eng.decode_steps, 5
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    if eng.decode_steps != steps0 + reps or any(s is None for s in eng.slots):
        raise AssertionError(f"{name}: the timed steps were not all "
                             f"full-occupancy decode steps")

    # a copy of the live caches, so timing leaves the engine's state alone;
    # replays append to it, and past its blocks they write the trash row
    caches = {k: type(c)(*(t.clone() for t in c))
              for k, c in eng.caches.items()}
    tok = torch.as_tensor(eng.last, device=dev)
    host = host_split(lambda: T.decode_step(params, cfg, tok, caches, plan))

    sub = tree_map(lambda a: a[0], params["layers"])["sub_0"]
    ws = [sub["mixer"][k] for k in ("wq", "wk", "wv", "wo")] + \
         [sub["mlp"][k] for k in ("w_in", "w_gate", "w_out")]
    parts = weight_parts(ws, m, cfg, plan, timer, dev)
    st = tree_map(lambda a: a[0], caches["sub_0"])
    lay = attn.head_layout(cfg.num_heads, cfg.num_kv_heads, 1)
    q = torch.randn((m, lay.KVp, lay.gp, cfg.resolved_head_dim()),
                    device=dev).bfloat16()
    parts["paged_attention"] = cfg.num_layers * timer.ms(
        lambda: pa.paged_attention(q, st.k_pool, st.v_pool, st.block_table,
                                   st.lengths))
    xh = torch.randn((m, 1, cfg.d_model), device=dev).bfloat16()
    head = plan.head_policy if plan else DEFAULT_POLICY
    parts["lm_head"] = timer.ms(lambda: lm_logits(params["lm_head"], xh,
                                                  head))
    device_step_ms = timer.ms(
        lambda: T.decode_step(params, cfg, tok, caches, plan), scrub=False)
    # what a sampled or a hardened step adds beside the greedy step above:
    # the token pick on the step's bf16 logits, and the whole pool's
    # per-block checksums
    logits = lm_logits(params["lm_head"], xh, head)[:, -1]
    knobs = (torch.ones(m, device=dev),
             torch.tensor([0, 50] * (m // 2), dtype=torch.int32, device=dev),
             torch.arange(m, dtype=torch.int32, device=dev) - 3,
             torch.full((m,), 7, dtype=torch.int32, device=dev))
    beside = {"argmax": timer.ms(lambda: torch.argmax(logits, dim=-1)),
              "sample_logits": timer.ms(lambda: sample_logits(logits,
                                                              *knobs)),
              "pool_checksums": timer.ms(eng._checksum)}
    report(cfg, name, card, m, step_ms, device_step_ms, host, parts, beside)


def rwkv_breakdown(params, cfg, plan, name: str, card: str, timer,
                   dev) -> None:
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.core.tree import tree_map
    from repro_torch.models import rwkv as rwk
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import lm_logits
    from repro_torch.runtime.serve import Request, engine_or_windowed

    m, prompt_len, max_len = 8, 128, 160
    srv = engine_or_windowed(params, cfg, plan=plan, device=dev,
                             max_slots=m, prompt_len=prompt_len,
                             max_len=max_len)
    rng = np.random.default_rng(4)
    for i in range(m):
        srv.submit(Request(i, rng.integers(0, cfg.vocab_size, 16)
                           .astype(np.int32), max_new=32))
    srv.step()                          # the window's prefill
    srv.step()
    torch.cuda.synchronize()
    steps0, reps = srv.decode_steps, 5
    t0 = time.perf_counter()
    for _ in range(reps):
        srv.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    if srv.decode_steps != steps0 + reps or srv.occupancy != 1.0:
        raise AssertionError(f"{name}: the timed steps were not all "
                             f"full-window decode steps")

    # the same decode step on a state of its own, prefilled and stepped
    # once so its dtypes are the ones decode sees
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (m, prompt_len)),
                           dtype=torch.int32, device=dev)
    out = T.prefill(params, cfg, toks,
                    T.init_cache(cfg, m, max_len, device=dev), plan)
    tok = torch.argmax(out.logits[:, -1], dim=-1)[:, None].int()
    caches = T.decode_step(params, cfg, tok, out.cache, plan).cache
    host = host_split(lambda: T.decode_step(params, cfg, tok, caches, plan))

    sub = tree_map(lambda a: a[0], params["layers"])["sub_0"]
    ws = [sub["mixer"][k] for k in ("w_r", "w_k", "w_v", "w_g", "w_o")] + \
         [sub["mlp"][k] for k in ("w_kc", "w_vc", "w_rc")]
    parts = weight_parts(ws, m, cfg, plan, timer, dev)
    hp, n, _ = rwk.rwkv_dims(cfg, 1)
    r, k, v, w = (torch.randn((m, hp, n), device=dev) for _ in range(4))
    u = torch.randn((hp, n), device=dev)
    state = caches["sub_0"][0].s

    def recurrence():                   # time_mix_decode's exact step
        kv = k[..., None] * v[..., None, :]
        torch.einsum("bhn,bhnm->bhm", r, state + u[None, ..., None] * kv)
        return w[..., None] * state + kv
    parts["wkv_decode_step"] = cfg.num_layers * timer.ms(recurrence)
    xh = torch.randn((m, 1, cfg.d_model), device=dev).bfloat16()
    head = plan.head_policy if plan else DEFAULT_POLICY
    parts["lm_head"] = timer.ms(lambda: lm_logits(params["lm_head"], xh,
                                                  head))
    device_step_ms = timer.ms(
        lambda: T.decode_step(params, cfg, tok, caches, plan), scrub=False)
    report(cfg, name, card, m, step_ms, device_step_ms, host, parts)


def jamba_breakdown(params, cfg, plan, name: str, card: str, timer,
                    dev) -> None:
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.core.tree import tree_map
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import lm_logits
    from repro_torch.runtime.serve import Request, engine_or_windowed

    m, prompt_len, max_len = 8, 128, 160
    srv = engine_or_windowed(params, cfg, plan=plan, device=dev,
                             max_slots=m, prompt_len=prompt_len,
                             max_len=max_len)
    rng = np.random.default_rng(4)
    for i in range(m):
        srv.submit(Request(i, rng.integers(0, cfg.vocab_size, 16)
                           .astype(np.int32), max_new=32))
    srv.step()                          # the window's prefill
    srv.step()
    torch.cuda.synchronize()
    steps0, reps = srv.decode_steps, 5
    t0 = time.perf_counter()
    for _ in range(reps):
        srv.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    if srv.decode_steps != steps0 + reps or srv.occupancy != 1.0:
        raise AssertionError(f"{name}: the timed steps were not all "
                             f"full-window decode steps")

    # the same decode step on caches of its own, prefilled and stepped once
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (m, prompt_len)),
                           dtype=torch.int32, device=dev)
    out = T.prefill(params, cfg, toks,
                    T.init_cache(cfg, m, max_len, device=dev), plan)
    tok = torch.argmax(out.logits[:, -1], dim=-1)[:, None].int()
    caches = T.decode_step(params, cfg, tok, out.cache, plan).cache
    host = host_split(lambda: T.decode_step(params, cfg, tok, caches, plan))

    pat = T.sublayer_pattern(cfg)
    blk = tree_map(lambda a: a[0], params["layers"])
    ws, moes, mambas = [], [], []
    for j, (kind, is_moe) in enumerate(pat):
        sub = blk[f"sub_{j}"]
        if kind == "attention":
            ws += [sub["mixer"][k] for k in ("wq", "wk", "wv", "wo")]
            kv = tree_map(lambda a: a[0], caches[f"sub_{j}"])
        else:
            ws += [sub["mixer"][k] for k in ("in_proj", "x_proj",
                                             "out_proj")]
            mambas.append((sub["mixer"], caches[f"sub_{j}"][0]))
        if is_moe:
            moes.append(sub["mlp"])
        else:
            ws += [sub["mlp"][k] for k in ("w_in", "w_gate", "w_out")]
    n_super = cfg.num_layers // len(pat)
    parts = weight_parts(ws, m, cfg, plan, timer, dev)
    policy = plan.segments[0].policy if plan else DEFAULT_POLICY
    dt = policy.precision.compute_dtype
    cast = lambda p: [p[k].to(dt) for k in ("w_in", "w_gate", "w_out")]
    parts["moe_expert_cast"] = n_super * sum(
        timer.ms(lambda: cast(p)) for p in moes)
    # the flat decode dispatch: every expert runs its t * k slots
    buf = torch.randn((cfg.moe.num_experts, m * cfg.moe.top_k,
                       cfg.d_model), device=dev).to(dt)
    einsum_ms = 0.0
    for p in moes:
        experts = dict(zip(("w_in", "w_gate", "w_out"), cast(p)))
        einsum_ms += timer.ms(lambda: moe_mod._expert_ffn(
            experts, buf, cfg.act, cfg.glu, policy))
        del experts
    parts["moe_expert_einsum"] = n_super * einsum_ms
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    dt_, xcf = (torch.rand((m, di), device=dev) * 0.1,
                torch.randn((m, di), device=dev))
    b_t, c_t = (torch.randn((m, mc.d_state), device=dev) for _ in range(2))

    def recurrence(mix, st):            # mamba_decode_step's exact step
        a = -torch.exp(mix["A_log"])
        h = (torch.exp(dt_[..., None] * a) * st.h
             + (dt_ * xcf)[..., None] * b_t[:, None, :])
        return torch.einsum("bdn,bn->bd", h, c_t) + xcf * mix["D"]
    parts["mamba_decode_step_recurrence"] = n_super * sum(
        timer.ms(lambda: recurrence(mix, st)) for mix, st in mambas)
    lay = attn.head_layout(cfg.num_heads, cfg.num_kv_heads, 1)
    hd = cfg.resolved_head_dim()
    q = torch.randn((m, 1, lay.KVp, lay.gp, hd), device=dev)

    def dense_attention():              # decode_attention_apply's read
        s = torch.einsum("bskgd,btkd->bkgst", q,
                         attn._cache_deq(kv.k, kv.k_scale))
        w = torch.softmax(s, dim=-1)
        return torch.einsum("bkgst,btkd->bskgd", w,
                            attn._cache_deq(kv.v, kv.v_scale))
    parts["dense_decode_attention"] = n_super * timer.ms(dense_attention)
    xh = torch.randn((m, 1, cfg.d_model), device=dev).bfloat16()
    head = plan.head_policy if plan else DEFAULT_POLICY
    parts["lm_head"] = timer.ms(lambda: lm_logits(params["lm_head"], xh,
                                                  head))
    device_step_ms = timer.ms(
        lambda: T.decode_step(params, cfg, tok, caches, plan), scrub=False)
    report(cfg, name, card, m, step_ms, device_step_ms, host, parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("step_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import jamba_v0_1_52b, qwen3_14b, rwkv6_3b
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    timer = GraphTimer(dev)
    for cfg, run in ((qwen3_14b.FULL, breakdown),
                     (rwkv6_3b.FULL, rwkv_breakdown),
                     (jamba_v0_1_52b.FULL.with_(num_layers=8),
                      jamba_breakdown)):
        params = T.model_init(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        for name, plan in (("mpai", qat.serve_plan(PartitionPlan.mpai(
                cfg.num_layers))), ("bf16", None)):
            run(params, cfg, plan, name, card, timer, dev)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
