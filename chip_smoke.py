#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the shapes the serving path gives
it, serves a tiny model on CUDA and on the CPU and compares the greedy
streams, then serves 12 greedy requests of the full-width Qwen3-14B config
(random weights from a seed) through ``ContinuousBatchingEngine`` under the
``"mpai"`` plan and the bf16 plan.  Prints one JSON line per phase, the
card's name and power limit, a ``{"kernels": [...]}`` line, and as its last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero; it also exits non-zero where there is no CUDA
device.  Needs one card with 80 GB (the full-width f32 weights take 59 GB).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8
# tensor-core ops/s, f32 CUDA-core flops/s.  bound_ms uses them.
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12

PAGED_ATTENTION_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
INT8_MATMUL_SRC = "src/repro_torch/kernels/csrc/int8_matmul.cu"
PAGED_ATTENTION_TPU = "src/repro/kernels/paged_attention.py:92"
INT8_MATMUL_TPU = "src/repro/kernels/int8_matmul.py:44"

# One Qwen3-14B decoder layer's int8 GEMMs, (K, N) each: wq, wk, wv, wo,
# w_in, w_gate, w_out.
QWEN_LAYER_GEMMS = [(5120, 5120), (5120, 1024), (5120, 1024), (5120, 5120),
                    (5120, 17408), (5120, 17408), (17408, 5120)]


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, each after a
    write of 128 MB that evicts the 50 MB L2 (the serving path reads each
    weight and each KV block once per step, so it finds them cold)."""

    def __init__(self, device):
        self.scrub = torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                 device=device)

    def ms(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def paged_attention_phase(timer, pa, dev) -> dict:
    """The paged-decode kernel against its plain version at Qwen3-14B
    decode shapes: B = 8 slots, KVp = 8, gp = 5, hd = 128, P = 16, a pool
    of 64 blocks plus the trash row, table width 8 (max_len 128)."""
    b, kvp, gp, hd, page, mb, num_blocks = 8, 8, 5, 128, 16, 8, 64
    lengths = np.array([0, 1, 16, 17, 40, 77, 127, 128], np.int32)
    rng = np.random.default_rng(0)
    free = rng.permutation(num_blocks)
    table = -np.ones((b, mb), np.int32)
    used = 0
    for i, n in enumerate(-(-lengths // page)):
        table[i, :n] = free[used:used + n]
        used += n
    table[0, 0] = free[used]          # a stale entry of a length-0 slot
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (num_blocks + 1, page, kvp, hd)
    k_pool = torch.randn(shape, generator=g, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=g, device=dev).bfloat16()
    k_pool[-1] = float("nan")         # the trash row: any read shows as NaN
    v_pool[-1] = float("nan")
    q = torch.randn((b, kvp, gp, hd), generator=g, device=dev).bfloat16()
    tbl = torch.as_tensor(table, device=dev)
    lens = torch.as_tensor(lengths, device=dev)
    args = (q, k_pool, v_pool, tbl, lens)

    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args)
    if not torch.isfinite(out).all():
        raise AssertionError("paged_attention read a NaN (trash row or dead "
                             "entry)")
    if not torch.equal(out[0], torch.zeros_like(out[0])):
        raise AssertionError("paged_attention: a length-0 slot is not 0")
    err = (out.float() - ref.float()).abs()
    # both sides accumulate in f32, in different orders, and round to
    # bf16: they may differ by a bf16 ulp or two (2**-7 relative each)
    tol = 2 ** -6 * ref.float().abs() + 2 ** -10
    if not bool((err <= tol).all()):
        raise AssertionError(f"paged_attention disagrees with its plain "
                             f"version: max |err| {err.max().item()}")
    blocks = int((-(-lengths // page)).sum())
    kv_bytes = 2 * blocks * page * kvp * hd * 2
    nbytes = kv_bytes + 2 * q.numel() * 2 + table.nbytes + lengths.nbytes
    flops = 4 * int(lengths.sum()) * kvp * gp * hd
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    row = {"name": "paged_attention", "route": "cuda",
           "source": PAGED_ATTENTION_SRC, "replaces": PAGED_ATTENTION_TPU,
           "launches": 0, "max_abs_err": err.max().item(),
           "ms": timer.ms(lambda: pa.paged_attention(*args)),
           "plain_ms": timer.ms(lambda: pa.paged_attention_plain(*args)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None,
           "shapes": f"one decode layer: B={b} KVp={kvp} gp={gp} hd={hd} "
                     f"P={page} lengths={lengths.tolist()}"}
    emit("kernel_paged_attention", **row, tolerance="2**-6 * |ref| + 2**-10")
    return row


def int8_matmul_phase(timer, im, dev) -> dict:
    """The int8 GEMM against its plain version, bit for bit, at every
    (K, N) of a Qwen3-14B layer, at decode (M = 8 slots) and at a full
    bucket prefill (M = 8 x 32); times it per shape."""
    g = torch.Generator(device=dev).manual_seed(1)
    per_shape = {}
    for m in (8, 8 * 32):
        for k, n in sorted(set(QWEN_LAYER_GEMMS)):
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                              dtype=torch.int8)
            out = im.int8_matmul(x, w)
            torch.cuda.synchronize()
            if not torch.equal(out, im.int8_matmul_plain(x, w)):
                raise AssertionError(f"int8_matmul != plain at M={m} K={k} "
                                     f"N={n}")
            try:     # the library yardstick only; the port never calls it
                lib_ms = timer.ms(lambda: torch._int_mm(x, w))
            except RuntimeError as e:
                lib_ms, lib_note = None, str(e).splitlines()[0]
            else:
                lib_note = None
            nbytes = m * k + k * n + 4 * m * n
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 2 * m * k * n / PEAK_INT8_OPS * 1e3
            per_shape[(m, k, n)] = {
                "ms": timer.ms(lambda: im.int8_matmul(x, w)),
                "plain_ms": timer.ms(lambda: im.int8_matmul_plain(x, w)),
                "library_ms": lib_ms, "t_bytes": t_bytes, "t_ops": t_ops}
            emit("kernel_int8_matmul", M=m, K=k, N=n, exact=True,
                 splits=im.k_splits(m, k, n, im.sm_count(dev.index)),
                 ms=per_shape[(m, k, n)]["ms"],
                 plain_ms=per_shape[(m, k, n)]["plain_ms"],
                 library_ms=lib_ms, library_note=lib_note,
                 bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    # the kernels line reports one decode layer's seven GEMMs at M = 8
    layer = [per_shape[(8, k, n)] for k, n in QWEN_LAYER_GEMMS]
    lib = [r["library_ms"] for r in layer]
    t_bytes = sum(r["t_bytes"] for r in layer)
    t_ops = sum(r["t_ops"] for r in layer)
    return {"name": "int8_matmul", "route": "cuda", "source": INT8_MATMUL_SRC,
            "replaces": INT8_MATMUL_TPU, "launches": 0, "max_abs_err": 0.0,
            "ms": sum(r["ms"] for r in layer),
            "plain_ms": sum(r["plain_ms"] for r in layer),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
            "shapes": "one decode layer: the 7 GEMMs of a Qwen3-14B layer "
                      "at M=8, summed"}


def tiny_params(cfg, seed: int) -> dict:
    """Reference-layout weights from a seeded numpy RNG (numpy tree, as the
    bridge takes it)."""
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim()
    n, h, kv = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32)
    ones = lambda *s: np.ones(s, np.float32)
    return {"embed": (rng.normal(size=(cfg.vocab_size, d)) * 0.02
                      ).astype(np.float32),
            "layers": {"sub_0": {
                "norm1": {"scale": ones(n, d)}, "norm2": {"scale": ones(n, d)},
                "mixer": {"wq": w(n, d, h * hd), "wk": w(n, d, kv * hd),
                          "wv": w(n, d, kv * hd), "wo": w(n, h * hd, d),
                          "q_norm": {"scale": ones(n, hd)},
                          "k_norm": {"scale": ones(n, hd)}},
                "mlp": {"w_in": w(n, d, f), "w_gate": w(n, d, f),
                        "w_out": w(n, f, d)}}},
            "final_norm": {"scale": ones(d)},
            "lm_head": (rng.normal(size=(cfg.vocab_size, d)) * 0.02
                        ).astype(np.float32)}


def serve(engine, trace, request_cls) -> dict:
    for rid, prompt, max_new in trace:
        engine.submit(request_cls(rid, prompt, max_new=max_new))
    steps = 0
    while engine.pending:
        engine.step()
        steps += 1
        if steps > 10_000:
            raise AssertionError("engine made no progress")
    return {rid: engine.done[rid].output.tolist() for rid, _, _ in trace}


def tiny_phase(dev) -> None:
    """The tiny config through the engine on CUDA (kernels) and on the CPU
    (plain versions), same bridged weights, same trace: equal greedy
    streams, unless the CPU logits are a near-tie where they part."""
    from repro_torch import bridge
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import ContinuousBatchingEngine, Request

    cfg = ModelConfig(name="tiny-qk", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=256, qk_norm=True, remat=False)
    weights = tiny_params(cfg, seed=0)
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 256, 20).astype(np.int32)
    trace = []
    for rid in range(9):
        if rid in (2, 5):             # over-bucket prompts sharing a prefix
            p = np.concatenate([shared, rng.integers(0, 256, 3)]).astype(np.int32)
        else:
            p = rng.integers(0, 256, int(rng.integers(1, 9))).astype(np.int32)
        trace.append((rid, p, [0, 1, 6, 8, 3, 7, 4, 2, 5][rid]))
    kw = dict(max_slots=3, prompt_len=8, max_len=40, block_size=4)
    for name, plan in (("mpai", qat.serve_plan(PartitionPlan.mpai(2))),
                       ("bf16", None)):
        streams = {}
        for where in (dev, torch.device("cpu")):
            params = bridge.to_torch(weights, where)
            eng = ContinuousBatchingEngine(params, cfg, plan=plan,
                                           device=where, **kw)
            streams[where.type] = serve(eng, trace, Request)
            if where.type == "cpu":
                cpu_params, padded_len = params, eng.padded_prompt_len
        ties = 0
        for rid, prompt, _ in trace:
            a, b = streams["cuda"][rid], streams["cpu"][rid]
            if a == b:
                continue
            t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            ctx = np.zeros(padded_len(len(prompt)), np.int32)
            ctx[-len(prompt):] = prompt
            ctx = np.concatenate([ctx, np.asarray(b[:t], np.int32)])
            logits = T.forward(cpu_params, cfg, torch.as_tensor(ctx[None]),
                               plan).logits[0, -1].float()
            top2 = torch.topk(logits, 2).values
            margin = float(top2[0] - top2[1])
            # a tie within 4 bf16 ulps of the top logit: CUDA and CPU GEMMs
            # sum in different orders and may rank such a pair either way
            if margin > 2 ** -5 * abs(float(top2[0])):
                raise AssertionError(
                    f"tiny {name}: request {rid} diverges at token {t} "
                    f"(cuda {a[t]}, cpu {b[t]}) with top-2 margin {margin}")
            ties += 1
        emit("tiny_engine", plan=name, requests=len(trace),
             tokens=sum(len(s) for s in streams["cuda"].values()),
             streams_equal=len(trace) - ties, near_tie_divergences=ties)


def full_width_phase(dev, card: str, pa, im) -> dict:
    """Qwen3-14B at full width through the engine, under "mpai" and bf16.
    Returns each kernel's launches in each plan's run, counted from 0."""
    from repro_torch.configs.qwen3_14b import FULL
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import ContinuousBatchingEngine, Request

    cfg = FULL
    t0 = time.perf_counter()
    params = T.model_init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    emit("full_width_init", config=cfg.name, seconds=time.perf_counter() - t0,
         param_gb=torch.cuda.memory_allocated(dev) / 1e9)
    rng = np.random.default_rng(3)
    trace = []
    for rid in range(12):
        n = (int(rng.integers(40, 65)) if rid in (4, 9)
             else int(rng.integers(2, 33)))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        trace.append((rid, prompt, 1 if rid == 2 else int(rng.integers(1, 33))))
    kw = dict(max_slots=8, prompt_len=32, max_len=128, block_size=16)
    warm = [(-1, np.array([1, 2, 3], np.int32), 2),
            (-2, np.arange(1, 41, dtype=np.int32), 2)]

    launches = {"paged_attention": {}, "int8_matmul": {}}
    mpai = qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
    for name, plan in (("mpai", mpai), ("bf16", None)):
        eng = ContinuousBatchingEngine(params, cfg, plan=plan, device=dev,
                                       **kw)
        serve(eng, warm, Request)     # first-use costs (cuBLAS, allocator)
        eng.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        pa.paged_attention.launches = 0   # the main path's counts start here
        im.int8_matmul.launches = 0
        t0 = time.perf_counter()
        out = serve(eng, trace, Request)
        wall = time.perf_counter() - t0
        pa_n, im_n = pa.paged_attention.launches, im.int8_matmul.launches
        launches["paged_attention"][name] = pa_n
        launches["int8_matmul"][name] = im_n
        st = eng.stats()
        for rid, _, max_new in trace:
            toks = out[rid]
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
                raise AssertionError(f"{name}: request {rid} returned "
                                     f"{toks} for max_new={max_new}")
        steps = st["decode_steps"]
        if pa_n != cfg.num_layers * steps:
            raise AssertionError(f"{name}: {pa_n} paged_attention launches "
                                 f"for {steps} decode steps")
        if (im_n > 0) != (name == "mpai"):
            raise AssertionError(f"{name}: {im_n} int8_matmul launches")
        emit("full_width_serve", plan=name, card=card, requests=len(trace),
             tokens=st["total_tokens"], decode_steps=steps,
             decode_tok_s=st["decode_tokens"] / st["decode_s"],
             mean_step_ms=st["decode_s"] / steps * 1e3,
             admit_s=st["admit_s"], wall_s=wall,
             mean_occupancy=st["mean_occupancy"],
             deferrals=st["deferrals"],
             shared_block_hits=st["shared_block_hits"],
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             paged_attention_launches=pa_n, int8_matmul_launches=im_n)
        del eng
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    reports = build.build()
    ptxas = [ln.strip() for text in reports.values()
             for ln in text.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=build.sources(),
         ptxas=ptxas)

    timer = Timer(dev)
    rows = [paged_attention_phase(timer, pa, dev),
            int8_matmul_phase(timer, im, dev)]
    tiny_phase(dev)
    launches = full_width_phase(dev, card, pa, im)
    for row in rows:
        # each plan's run is a main path, counted from 0 on its own;
        # "launches" is their sum and "launches_by_plan" keeps them apart
        row["launches_by_plan"] = launches[row["name"]]
        row["launches"] = sum(launches[row["name"]].values())
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
