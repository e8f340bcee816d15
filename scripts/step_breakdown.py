#!/usr/bin/env python3
"""Where a full-occupancy decode step of the PyTorch port goes, on one card.

    python3 scripts/step_breakdown.py

Serves Qwen3-14B at full width (random weights from seed 0) through
``ContinuousBatchingEngine`` with all 8 slots live, under the ``"mpai"``
plan and then the bf16 plan, and prints one JSON line per plan:

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
  kernel on the live caches, and the lm head.  ``other_device_ms`` is the
  rest of ``device_step_ms``: norms, rope, epilogues, KV appends.

Needs one card with 80 GB; builds the port's kernels on first use.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

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


def breakdown(params, cfg, plan, name: str, card: str, timer, dev) -> None:
    from repro_torch.core.precision import DEFAULT_POLICY
    from repro_torch.core.quantization import quantize
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ops import int8_matmul
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import lm_logits
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
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.decode_step(params, cfg, tok, caches, plan)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))

    sub = tree_map(lambda a: a[0], params["layers"])["sub_0"]
    ws = [sub["mixer"][k] for k in ("wq", "wk", "wv", "wo")] + \
         [sub["mlp"][k] for k in ("w_in", "w_gate", "w_out")]
    n_int8 = sum(s.num_layers for s in (plan.segments if plan else ())
                 if s.policy.mode == "quant")
    n_bf16 = cfg.num_layers - n_int8
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
    print(json.dumps({
        "phase": "step_breakdown", "plan": name, "card": card, "slots": m,
        "step_ms": step_ms, "device_step_ms": device_step_ms,
        "idle_share": 1 - device_step_ms / step_ms,
        "enqueue_ms": float(np.median([h[0] for h in host])),
        "enqueue_and_run_ms": float(np.median([h[1] for h in host])),
        "parts_ms": parts,
        "other_device_ms": device_step_ms - sum(parts.values())}),
        flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("step_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.qwen3_14b import FULL
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
    params = T.model_init(FULL, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    timer = GraphTimer(dev)
    for name, plan in (("mpai", qat.serve_plan(PartitionPlan.mpai(
            FULL.num_layers))), ("bf16", None)):
        breakdown(params, FULL, plan, name, card, timer, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
