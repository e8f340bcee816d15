#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version at the shapes the serving paths give
it (paged attention at the Qwen3 decode layer and at 4096-token contexts;
the int8 GEMM at decode, admission-bucket and window-prefill M; flash
attention at the Qwen3 admission round, Jamba's prefill window and a
2048-token prefill; wkv at the RWKV window and a 2048-token prompt; the
selective scan at Jamba's prefill window and a 2048-token prompt; the
row-wise quant at the int8 KV cache's rows, standalone and fused into the
cache write at decode slots and in the prefill layout) and times each
around its wrapper (``ms``) and as a CUDA-graph replay of one wrapper call
(``device_ms``, the kernel without the host), serves tiny models on CUDA
and on the CPU and compares the greedy streams (a dense and a MoE stack
through the engine; ``rwkv6-smoke``, ``jamba-smoke``, a dense stack with a
biting sliding window, one with int8 KV and one with both through the
windowed fallback), then drives the three full-width main paths with 12
greedy requests each (random weights from a seed): RWKV-6 3B through
``engine_or_windowed``'s windowed fallback (wkv kernel in every prefill
layer) under ``"mpai"`` and bf16; Jamba-v0.1 at full width, one 8-layer
super-block deep, through the same fallback (selective scan in every Mamba
prefill, flash attention in the attention prefill, the row-wise quant fused
into every int8 KV write) under ``"mpai"``, bf16 and ``"mpai"`` with int8
KV; then
Qwen3-14B through ``ContinuousBatchingEngine`` (flash attention in every
admission round, paged attention in every decode step) under ``"mpai"`` and
bf16. Each full-width run also prints the histogram of the ``(M, K, N)``
shapes its int8 GEMMs took. Prints one JSON line per phase, the card's name
and power limit, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; it also exits non-zero where there is no CUDA device.
Needs one card with 80 GB (the Qwen3-14B f32 weights take 59 GB, Jamba's
53 GB; each phase frees its weights before the next one makes its own).
"""
from __future__ import annotations

import collections
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, int8
# and bf16 tensor-core ops/s, f32 CUDA-core flops/s.  bound_ms uses them.
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

PAGED_ATTENTION_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
INT8_MATMUL_SRC = "src/repro_torch/kernels/csrc/int8_matmul.cu"
FLASH_ATTENTION_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
WKV_SRC = "src/repro_torch/kernels/csrc/wkv.cu"
SELECTIVE_SCAN_SRC = "src/repro_torch/kernels/csrc/selective_scan.cu"
ROWWISE_QUANT_SRC = "src/repro_torch/kernels/csrc/rowwise_quant.cu"
PAGED_ATTENTION_TPU = "src/repro/kernels/paged_attention.py:92"
INT8_MATMUL_TPU = "src/repro/kernels/int8_matmul.py:44"
FLASH_ATTENTION_TPU = "src/repro/kernels/flash_attention.py:74"
WKV_TPU = "src/repro/kernels/wkv.py:49"
SELECTIVE_SCAN_TPU = "src/repro/kernels/selective_scan.py:63"
ROWWISE_QUANT_TPU = "src/repro/kernels/quant.py:33"

# The RWKV-6 3B serving shape: windows of 8 requests, prompts left-padded
# to 128 tokens (the wkv kernel's S), room for 32 new tokens.
RWKV_SERVE = dict(max_slots=8, prompt_len=128, max_len=160)
# Jamba-v0.1 is served at the RWKV shape: windows of 8, S = 128 for the
# selective scan and the flash kernel, decode against a 160-slot KV cache.
JAMBA_SERVE = RWKV_SERVE
JAMBA_LAYERS = 8          # one super-block: 1 attention + 7 Mamba layers
# The Qwen3-14B engine shape (the flash kernel's S is prompt_len).
QWEN_SERVE = dict(max_slots=8, prompt_len=32, max_len=128, block_size=16)

# One Qwen3-14B decoder layer's int8 GEMMs, (K, N) each: wq, wk, wv, wo,
# w_in, w_gate, w_out.
QWEN_LAYER_GEMMS = [(5120, 5120), (5120, 1024), (5120, 1024), (5120, 5120),
                    (5120, 17408), (5120, 17408), (17408, 5120)]
# The widths of a window prefill (M = 8 x 128): RWKV-6 3B's projections and
# channel mix, Jamba-v0.1's Mamba in_proj and out_proj.
WINDOW_GEMMS = [(2560, 2560), (2560, 8960), (8960, 2560), (4096, 16384),
                (8192, 4096)]
# torch._int_mm takes M > 16 only: the decode yardstick pads x with zero rows
INT_MM_PAD_M = 32


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


class Timer:
    """Median device time of ``fn`` over ``reps`` launches, each after a
    write of 128 MB that evicts the 50 MB L2 (the serving path reads each
    weight and each KV block once per step, so it finds them cold).  With
    ``clean``, the scrub reads the 128 MB instead: the L2 is as cold but
    holds no dirty lines for the launch to write back."""

    def __init__(self, device, clean: bool = False):
        self.scrub = torch.zeros(32 * 2 ** 20, dtype=torch.float32,
                                 device=device)
        self.flush = (lambda: self.scrub.sum()) if clean else self.scrub.zero_

    def ms(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))

    def device_ms(self, fn, reps: int = 15) -> float:
        """Median device time of one ``fn`` call captured in a CUDA graph
        and replayed after the same scrub: the kernel without the wrapper's
        host time (``ms`` brackets the wrapper)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()                      # scratch and counters of this stream
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        del graph
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def within(got, want, rel: float, abs_: float):
    """(max |got - want|, every element within rel * |want| + abs_)."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= rel * want.float().abs()
                                   + abs_).all())


def paged_case(dev, lengths, seed: int, num_blocks: int = 0,
               page: int = 16, kvp: int = 8, gp: int = 5,
               hd: int = 128) -> tuple:
    """Paged-decode inputs: a pool of ``num_blocks`` blocks (at least the
    live ones and one more) plus a NaN trash row (any read of it shows), a
    shuffled block per live table column, -1 past each length, and a stale
    entry left in a length-0 slot's first column."""
    lengths = np.asarray(lengths, np.int32)
    b, need = len(lengths), -(-lengths // page)
    mb = max(1, int(need.max()))
    num_blocks = max(num_blocks, int(need.sum()) + 1)
    free = np.random.default_rng(seed).permutation(num_blocks)
    table = -np.ones((b, mb), np.int32)
    used = 0
    for i, n in enumerate(need):
        table[i, :n] = free[used:used + n]
        used += n
    for i in np.flatnonzero(lengths == 0):
        table[i, 0] = free[used]      # a stale entry: must not be read
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (num_blocks + 1, page, kvp, hd)
    k_pool = torch.randn(shape, generator=g, device=dev).bfloat16()
    v_pool = torch.randn(shape, generator=g, device=dev).bfloat16()
    k_pool[-1] = float("nan")
    v_pool[-1] = float("nan")
    q = torch.randn((b, kvp, gp, hd), generator=g, device=dev).bfloat16()
    return (q, k_pool, v_pool, torch.as_tensor(table, device=dev),
            torch.as_tensor(lengths, device=dev))


# Paged decode attention (KVp 8, gp 5, hd 128, P 16): (label, lengths, pool
# blocks) of the Qwen3-14B decode layer (8 slots, table width 8 for max_len
# 128, a 64-block pool), of 8 sequences of 4096 tokens and of one
PAGED_CASES = (("qwen3 decode layer", [0, 1, 16, 17, 40, 77, 127, 128], 64),
               ("B=8 x 4096", [4096] * 8, 0), ("B=1 x 4096", [4096], 0))


def paged_attention_phase(timer, pa, dev) -> dict:
    """The paged-decode kernel against its plain version at ``PAGED_CASES``,
    each also as a CUDA graph replay (``device_ms``)."""
    rows = {}
    for seed, (label, lengths, num_blocks) in enumerate(PAGED_CASES):
        args = paged_case(dev, lengths, seed, num_blocks)
        q, k_pool, v_pool, tbl, lens = args
        b, kvp, gp, hd = q.shape
        page, mb = k_pool.shape[1], tbl.shape[1]
        out = pa.paged_attention(*args)
        again = pa.paged_attention(*args)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(*args)
        if not torch.isfinite(out).all():
            raise AssertionError(f"paged_attention read a NaN (trash row or "
                                 f"dead entry) at {label}")
        for i, n in enumerate(lengths):
            if n == 0 and not torch.equal(out[i], torch.zeros_like(out[i])):
                raise AssertionError("paged_attention: a length-0 slot is "
                                     "not 0")
        if not torch.equal(out, again):
            raise AssertionError(f"paged_attention: two launches differ at "
                                 f"{label}")
        # both sides accumulate in f32, in different orders, and round to
        # bf16: they may differ by a bf16 ulp or two (2**-7 relative each)
        err, ok = within(out, ref, 2 ** -6, 2 ** -10)
        if not ok:
            raise AssertionError(f"paged_attention disagrees with its plain "
                                 f"version at {label}: max |err| {err}")
        ln = np.asarray(lengths)
        blocks = int((-(-ln // page)).sum())
        kv_bytes = 2 * blocks * page * kvp * hd * 2
        nbytes = kv_bytes + 2 * q.numel() * 2 + 4 * tbl.numel() + 4 * b
        flops = 4 * int(ln.sum()) * kvp * gp * hd
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        rows[label] = {
            "max_abs_err": err, "bit_identical": True,
            "plan": pa.plan(b, kvp, mb, torch.cuda.get_device_properties(
                dev).multi_processor_count)._asdict(),
            "ms": timer.ms(lambda: pa.paged_attention(*args)),
            "device_ms": timer.device_ms(lambda: pa.paged_attention(*args)),
            "plain_ms": timer.ms(lambda: pa.paged_attention_plain(*args),
                                 reps=3 if mb > 8 else 15),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        emit("kernel_paged_attention", shape=label, B=b, KVp=kvp, gp=gp,
             hd=hd, P=page, MB=mb, **rows[label], library_ms=None,
             tolerance="2**-6 * |ref| + 2**-10")
        del args, q, k_pool, v_pool, out, again, ref
    main = rows["qwen3 decode layer"]
    return {"name": "paged_attention", "route": "cuda",
            "source": PAGED_ATTENTION_SRC, "replaces": PAGED_ATTENTION_TPU,
            "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": "one decode layer: B=8 KVp=8 gp=5 hd=128 P=16 "
                      "lengths=[0, 1, 16, 17, 40, 77, 127, 128]"}


def int8_matmul_phase(timer, im, dev) -> dict:
    """The int8 GEMM against its plain version, bit for bit, at every shape
    of the main paths: each (K, N) of a Qwen3-14B layer at decode (M = 8
    slots) and at a full admission bucket (M = 8 x 32), and RWKV-6's and
    Jamba's widths at a window prefill (M = 8 x 128); times it per shape
    beside ``torch._int_mm`` (at M = 8 on x padded with zero rows to
    ``INT_MM_PAD_M``: ``_int_mm`` refuses M <= 16)."""
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [(m, k, n) for m in (8, 8 * 32)
              for k, n in sorted(set(QWEN_LAYER_GEMMS))]
    shapes += [(8 * 128, k, n) for k, n in WINDOW_GEMMS]
    per_shape = {}
    for m, k, n in shapes:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        out = im.int8_matmul(x, w)
        torch.cuda.synchronize()
        if not torch.equal(out, im.int8_matmul_plain(x, w)):
            raise AssertionError(f"int8_matmul != plain at M={m} K={k} N={n}")
        # the library yardstick only; the port never calls it
        xl = x if m > 16 else torch.cat(
            [x, x.new_zeros((INT_MM_PAD_M - m, k))])
        try:
            lib_ms = timer.ms(lambda: torch._int_mm(xl, w))
        except RuntimeError as e:
            lib_ms, lib_note = None, str(e).splitlines()[0]
        else:
            lib_note = (None if m > 16 else
                        f"torch._int_mm on x zero-padded to M={INT_MM_PAD_M}")
        nbytes = m * k + k * n + 4 * m * n
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 2 * m * k * n / PEAK_INT8_OPS * 1e3
        per_shape[(m, k, n)] = {
            "ms": timer.ms(lambda: im.int8_matmul(x, w)),
            "device_ms": timer.device_ms(lambda: im.int8_matmul(x, w)),
            "plain_ms": timer.ms(lambda: im.int8_matmul_plain(x, w)),
            "library_ms": lib_ms, "t_bytes": t_bytes, "t_ops": t_ops}
        emit("kernel_int8_matmul", M=m, K=k, N=n, exact=True,
             plan=im.plan(m, k, n, sms)._asdict(),
             ms=per_shape[(m, k, n)]["ms"],
             device_ms=per_shape[(m, k, n)]["device_ms"],
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
            "device_ms": sum(r["device_ms"] for r in layer),
            "plain_ms": sum(r["plain_ms"] for r in layer),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None if None in lib else sum(lib),
            "library_note": f"torch._int_mm on x zero-padded to "
                            f"M={INT_MM_PAD_M} (it refuses M <= 16)",
            "shapes": "one decode layer: the 7 GEMMs of a Qwen3-14B layer "
                      "at M=8, summed"}


def flash_attention_phase(timer, fa, dev) -> dict:
    """The causal flash kernel against its plain version at the Qwen3-14B
    admission round (B = 8 slots, S = prompt_len = 32, KVp = 8, gp = 5,
    hd = 128), at Jamba's attention prefill (B = 8, S = 128, gp = 4), at a
    2048-token Qwen3 prefill and at a ragged S; beside each, one
    ``scaled_dot_product_attention`` call at the same shapes (timed only
    here: the port never calls it)."""
    g = torch.Generator(device=dev).manual_seed(4)
    kvp, hd = 8, 128
    rows, errs = {}, []
    for b, s, gp in ((QWEN_SERVE["max_slots"], QWEN_SERVE["prompt_len"], 5),
                     (JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"], 4),
                     (1, 2048, 5), (2, 301, 5)):
        q = torch.randn((b, s, kvp, gp, hd), generator=g,
                        device=dev).bfloat16()
        k = torch.randn((b, s, kvp, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((b, s, kvp, hd), generator=g, device=dev).bfloat16()
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v)
        if not torch.isfinite(out).all():
            raise AssertionError(f"flash_attention: non-finite at B={b} S={s}")
        err, ok = within(out, ref, 2 ** -6, 2 ** -10)
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at B={b} S={s}: max |err| {err}")
        errs.append(err)
        # the library yardstick on [B, H, S, hd]
        ql = q.reshape(b, s, kvp * gp, hd).transpose(1, 2).contiguous()
        kl, vl = (t.transpose(1, 2).contiguous() for t in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        try:
            lib_ms = timer.ms(lambda: sdpa(ql, kl, vl, is_causal=True,
                                           enable_gqa=True))
        except (RuntimeError, TypeError) as e:
            lib_ms, lib_note = None, str(e).splitlines()[0]
        else:
            lib_note = None
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * hd * (s * (s + 1) // 2) * b * kvp * gp
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        rows[(b, s, gp)] = {
            "ms": timer.ms(lambda: fa.flash_attention(q, k, v)),
            "device_ms": timer.device_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": timer.ms(lambda: fa.flash_attention_plain(q, k, v)),
            "library_ms": lib_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_cuda_core_ms": flops / PEAK_F32_FLOPS * 1e3,
            "max_abs_err": err}
        emit("kernel_flash_attention", B=b, S=s, KVp=kvp, gp=gp, hd=hd,
             **rows[(b, s, gp)], library_note=lib_note,
             tolerance="2**-6 * |ref| + 2**-10",
             bound_peak="bf16 tensor cores, 989 TFLOP/s")
    adm = rows[(QWEN_SERVE["max_slots"], QWEN_SERVE["prompt_len"], 5)]
    return {"name": "flash_attention", "route": "cuda",
            "source": FLASH_ATTENTION_SRC, "replaces": FLASH_ATTENTION_TPU,
            "launches": 0, "max_abs_err": max(errs),
            **{k: adm[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
            "shapes": f"one admission layer of Qwen3-14B: B=8 S=32 KVp={kvp} "
                      f"gp={gp} hd={hd}; bound on bf16 tensor cores"}


def wkv_phase(timer, wk, dev) -> dict:
    """The wkv kernel against its plain version, output and final state,
    at the RWKV-6 3B prefill window (B = 8, S = 128, H = 40, N = 64), at a
    ragged S and at one 2048-token prompt; two launches must agree bit for
    bit."""
    g = torch.Generator(device=dev).manual_seed(5)
    h, n = 40, 64
    rows, errs = {}, []
    for b, s in ((RWKV_SERVE["max_slots"], RWKV_SERVE["prompt_len"]),
                 (3, 37), (1, 2048)):
        mk = lambda: torch.randn((b, s, h, n), generator=g, device=dev)
        r, k, v = mk(), mk(), mk()
        w = torch.exp(-torch.exp(mk() - 1))
        u = torch.randn((h, n), generator=g, device=dev)
        y, s_fin = wk.wkv(r, k, v, w, u)
        y2, s_fin2 = wk.wkv(r, k, v, w, u)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(s_fin, s_fin2)):
            raise AssertionError(f"wkv: two launches differ at B={b} S={s}")
        y_p, s_p = wk.wkv_plain(r, k, v, w, u)
        # f32 recurrences summed in two orders (fma chain vs einsum)
        err_y, ok_y = within(y, y_p, 1e-4, 1e-4)
        err_s, ok_s = within(s_fin, s_p, 1e-4, 1e-4)
        if not (ok_y and ok_s):
            raise AssertionError(f"wkv disagrees with its plain version at "
                                 f"B={b} S={s}: max |err| y {err_y}, state "
                                 f"{err_s}")
        errs.append(max(err_y, err_s))
        nbytes = 4 * (5 * r.numel() + u.numel() + s_fin.numel())
        # per (b, t, h): r^T S (2 N^2), the decay and rank-1 update of S
        # (3 N^2); the u-bonus term is O(N)
        flops = 5 * n * n * b * s * h
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        rows[(b, s)] = {
            "ms": timer.ms(lambda: wk.wkv(r, k, v, w, u)),
            "device_ms": timer.device_ms(lambda: wk.wkv(r, k, v, w, u)),
            "plain_ms": timer.ms(lambda: wk.wkv_plain(r, k, v, w, u),
                                 reps=3 if s > 512 else 15),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err_y": err_y, "max_abs_err_state": err_s,
            "bit_identical": True}
        emit("kernel_wkv", B=b, S=s, H=h, N=n, **rows[(b, s)],
             library_ms=None, tolerance="1e-4 * |ref| + 1e-4")
    main = rows[(RWKV_SERVE["max_slots"], RWKV_SERVE["prompt_len"])]
    return {"name": "wkv", "route": "cuda", "source": WKV_SRC,
            "replaces": WKV_TPU, "launches": 0, "max_abs_err": max(errs),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": f"one RWKV-6 3B prefill layer: B=8 S=128 H={h} N={n}"}


# (B, S) of the selective scan (d_inner 8192, N 16): the Jamba prefill
# window, a ragged B and S, one 2048-token prompt
SCAN_SHAPES = ((JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"]),
               (3, 37), (1, 2048))


def scan_case(dev, b: int, s: int, g, dim: int = 8192, n: int = 16) -> tuple:
    """Selective-scan inputs (x, dt, B, C, A, D) as the Mamba mixer gives
    them: dt a softplus, A = -(1..N) per channel (Mamba's initial A)."""
    x = torch.randn((b, s, dim), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, dim), generator=g, device=dev) - 3)
    bm = torch.randn((b, s, n), generator=g, device=dev)
    cm = torch.randn((b, s, n), generator=g, device=dev)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device=dev).expand(dim, n).contiguous()
    return x, dt, bm, cm, a, torch.ones(dim, device=dev)


def quant_rows(dev, m: int, k: int, dtype, g):
    """Rows for the row-wise quant: magnitudes spread over rows, and an
    all-zero first row (the 1e-8 floor)."""
    x = (torch.randn((m, k), generator=g, device=dev)
         * torch.rand((m, 1), generator=g, device=dev) * 30).to(dtype)
    x[0] = 0
    return x


def selective_scan_phase(timer, ss, dev, sm_mhz: int) -> dict:
    """The selective-scan kernel against its plain version, output and final
    state, at the Jamba prefill window (B = 8, S = 128, d_inner = 8192,
    N = 16), at a ragged B and S, and at one 2048-token prompt; two
    launches must agree bit for bit.  ``sm_mhz`` (the card's top SM clock)
    prices the exps on the special-function unit."""
    g = torch.Generator(device=dev).manual_seed(8)
    dim, n = 8192, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, errs = {}, []
    for b, s in SCAN_SHAPES:
        args = scan_case(dev, b, s, g, dim, n)
        x, bm, a = args[0], args[2], args[4]
        y, h = ss.selective_scan(*args)
        y2, h2 = ss.selective_scan(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"selective_scan: two launches differ at "
                                 f"B={b} S={s}")
        y_p, h_p = ss.selective_scan_plain(*args)
        # f32 recurrences: an exp and fma chain against exp and einsum
        err_y, ok_y = within(y, y_p, 1e-4, 1e-4)
        err_h, ok_h = within(h, h_p, 1e-4, 1e-4)
        if not (ok_y and ok_h):
            raise AssertionError(f"selective_scan disagrees with its plain "
                                 f"version at B={b} S={s}: max |err| y "
                                 f"{err_y}, state {err_h}")
        errs.append(max(err_y, err_h))
        # each input read once, y and the final state written once
        nbytes = 4 * (3 * x.numel() + 2 * bm.numel() + a.numel() + dim
                      + h.numel())
        # per (b, t, d, n): one exp on the special-function unit (16 a
        # clock per SM) and dt*a, dt*x*B, the state's fma and the output's
        # fma on the f32 units (6 flops)
        cells = b * s * dim * n
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = max(cells / (16 * sms * sm_mhz * 1e6),
                    6 * cells / PEAK_F32_FLOPS) * 1e3
        rows[(b, s)] = {
            "ms": timer.ms(lambda: ss.selective_scan(*args)),
            "device_ms": timer.device_ms(lambda: ss.selective_scan(*args)),
            "plain_ms": timer.ms(lambda: ss.selective_scan_plain(*args),
                                 reps=3 if s > 512 else 15),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "lanes": ss.plan(b, dim, n, sms),
            "max_abs_err_y": err_y, "max_abs_err_state": err_h,
            "bit_identical": True}
        emit("kernel_selective_scan", B=b, S=s, D=dim, N=n, **rows[(b, s)],
             library_ms=None, tolerance="1e-4 * |ref| + 1e-4")
    main = rows[(JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"])]
    return {"name": "selective_scan", "route": "cuda",
            "source": SELECTIVE_SCAN_SRC, "replaces": SELECTIVE_SCAN_TPU,
            "launches": 0, "max_abs_err": max(errs),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": f"one Jamba Mamba prefill layer: B=8 S=128 D={dim} "
                      f"N={n}; the exps bound on the special-function "
                      f"unit at {sm_mhz} MHz"}


# (M, K) of the row-wise quant at the int8 KV cache's rows of the Jamba
# attention layer: a decode step's k or v, a prefill window's
QUANT_SHAPES = ((64, 128), (8192, 128))
# int8 KV writes of the Jamba attention layer (8 rows, KVp 8, hd 128, bf16
# k and v) into super-block 1 of a 2-deep stacked cache: (label, S, cache
# slots T, decode position or None for the prefill layout, sliding window)
KV_WRITE_CASES = (("jamba decode write", 1, 160, 37, False),
                  ("decode write, clamped slot", 1, 160, 200, False),
                  ("decode write, ring slot", 1, 4, 9, True),
                  ("jamba prefill window", 128, 160, None, False),
                  ("prefill window, s >= t", 8, 4, None, False))


def kv_write_case(dev, s: int, t: int, pos, ring: bool, seed: int,
                  b: int = 8, h: int = 8, hd: int = 128) -> tuple:
    """k, v [b, s, h, hd] bf16, and the codes and scales of an int8 cache
    of t slots holding random contents, as views of super-block 1 of a
    stack of 2 (as the windowed server keeps them); with the stack, and
    the decode slot of position ``pos`` as ``attention.decode_slot`` gives
    it (the ring slot under a sliding window, else clamped), or None for
    the prefill layout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k, v = ((torch.randn((b, s, h, hd), generator=g, device=dev)
             * torch.rand((b, s, h, 1), generator=g, device=dev) * 20
             ).bfloat16() for _ in range(2))
    k[0, 0, 0] = 0                                # the 1e-8 floor
    stack = [torch.randint(-127, 128, (2, b, t, h, hd), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    stack += [torch.rand((2, b, t, h, 1), generator=g, device=dev)
              for _ in range(2)]
    slot = None
    if pos is not None:
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        slot = p % t if ring else p.clamp(max=t - 1)
    return k, v, [w[1] for w in stack], stack, slot


def kv_write_sequence(rq, k, v, bufs, slot) -> None:
    """The int8 KV write unfused, the yardstick of the fused one: a row-wise
    quant launch for k and one for v, then four slot copies
    (``index_copy_`` at a decode slot, slice copies for a prefill)."""
    s, t = k.shape[1], bufs[0].shape[1]
    for src, q_buf, s_buf in ((k, bufs[0], bufs[2]), (v, bufs[1], bufs[3])):
        q, scale = rq.rowwise_quant(src.reshape(-1, src.shape[-1]))
        for buf, val in ((q_buf, q.reshape(src.shape)),
                         (s_buf, scale.reshape(*src.shape[:-1], 1))):
            if slot is not None:
                buf.index_copy_(1, slot.reshape(1).long(), val)
            elif s >= t:
                buf.copy_(torch.roll(val[:, s - t:], (s - t) % t, dims=1))
            else:
                buf[:, :s] = val


def rowwise_quant_phase(timer, rq, dev) -> dict:
    """The row-wise quant kernel against its plain version, codes and
    scales equal: standalone at the int8 KV cache's row shapes of the
    Jamba attention layer (a decode step's k or v: 8 x 1 x 8 heads of 128;
    a prefill window's: 8 x 128 x 8 heads), at a ragged M and K, in bf16
    and f32; and fused into the int8 KV write (``KV_WRITE_CASES``: k and v
    in one launch into a super-block view of a stacked cache, at decode
    slots and in the prefill layout), beside the unfused sequence of two
    quant launches and four copies (``sequence_ms``)."""
    g = torch.Generator(device=dev).manual_seed(9)
    rows, shapes = {}, QUANT_SHAPES + ((37, 96),)
    for dtype in (torch.bfloat16, torch.float32):
        for m, k in shapes:
            x = quant_rows(dev, m, k, dtype, g)
            q, scale = rq.rowwise_quant(x)
            torch.cuda.synchronize()
            q_p, s_p = rq.rowwise_quant_plain(x)
            if not (torch.equal(q, q_p) and torch.equal(scale, s_p)):
                raise AssertionError(f"rowwise_quant != plain at M={m} "
                                     f"K={k} {dtype}")
            nbytes = x.numel() * x.element_size() + q.numel() + 4 * m
            # per element: abs, max, divide, round, clamp
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = 5 * x.numel() / PEAK_F32_FLOPS * 1e3
            row = {"ms": timer.ms(lambda: rq.rowwise_quant(x)),
                   "device_ms": timer.device_ms(lambda: rq.rowwise_quant(x)),
                   "plain_ms": timer.ms(lambda: rq.rowwise_quant_plain(x)),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows[(m, k, dtype)] = row
            emit("kernel_rowwise_quant", M=m, K=k,
                 dtype=str(dtype).replace("torch.", ""), exact=True, **row,
                 library_ms=None)
    writes = {}
    for seed, (label, s, t, pos, ring) in enumerate(KV_WRITE_CASES):
        k, v, bufs, stack, slot = kv_write_case(dev, s, t, pos, ring, seed)
        kept, plain = stack[0][0].clone(), [b_.clone() for b_ in bufs]
        rq.rowwise_quant_into(k, v, *bufs, slot)
        torch.cuda.synchronize()
        rq.rowwise_quant_into_plain(k, v, *plain, slot)
        if not (all(torch.equal(a_, b_) for a_, b_ in zip(bufs, plain))
                and torch.equal(stack[0][0], kept)):
            raise AssertionError(f"int8 KV write != plain: {label}")
        written = k.shape[0] * min(s, t) * k.shape[2]
        nbytes = (2 * k.numel() * k.element_size()
                  + 2 * written * (k.shape[-1] + 4) + 4)
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = 5 * 2 * k.numel() / PEAK_F32_FLOPS * 1e3
        fused = lambda: rq.rowwise_quant_into(k, v, *bufs, slot)
        seq = lambda: kv_write_sequence(rq, k, v, bufs, slot)
        row = {"ms": timer.ms(fused), "device_ms": timer.device_ms(fused),
               "plain_ms": timer.ms(
                   lambda: rq.rowwise_quant_into_plain(k, v, *plain, slot)),
               "sequence_ms": timer.ms(seq),
               "sequence_device_ms": timer.device_ms(seq),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        writes[label] = row
        emit("kernel_int8_kv_write", case=label, S=s, T=t, decode_pos=pos,
             ring=ring, exact=True, **row, library_ms=None)
    main = writes["jamba decode write"]
    return {"name": "rowwise_quant", "route": "cuda",
            "source": ROWWISE_QUANT_SRC, "replaces": ROWWISE_QUANT_TPU,
            "launches": 0, "max_abs_err": 0.0,
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "sequence_ms",
                                    "sequence_device_ms")},
            "library_ms": None,
            "shapes": "the int8 KV write of a Jamba decode step, fused: k "
                      "and v [8, 1, 8, 128] bf16 quantized into their slot "
                      "of a super-block view, one launch"}


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


def port_weights(cfg, seed: int) -> dict:
    """The port's own random init of ``cfg`` on the CPU, as a numpy tree
    (what the bridge takes)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import transformer as T
    return tree_map(lambda a: a.numpy(), T.model_init(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))


def near_tie_divergences(what: str, streams: dict, trace, top2_of) -> int:
    """Requests whose CUDA and CPU greedy streams part.  Each must part at
    a near-tie of the CPU's top two logits (within 4 bf16 ulps of the top
    logit: CUDA and CPU sum in different orders and may rank such a pair
    either way); ``top2_of(rid, t)`` gives them."""
    ties = 0
    for rid, _, _ in trace:
        a, b = streams["cuda"][rid], streams["cpu"][rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = top2_of(rid, t)
        margin = float(top2[0] - top2[1])
        if margin > 2 ** -5 * abs(float(top2[0])):
            raise AssertionError(
                f"{what}: request {rid} diverges at token {t} (cuda {a[t]}, "
                f"cpu {b[t]}) with top-2 margin {margin}")
        ties += 1
    return ties


def tiny_phase(dev) -> None:
    """Tiny configs through the engine on CUDA (kernels) and on the CPU
    (plain versions), same bridged weights, same trace: equal greedy
    streams, unless the CPU logits are a near-tie where they part.  A
    dense stack with qk-norm, and a MoE stack (the engine serves MoE
    attention stacks; its experts are bf16 einsums, not a kernel)."""
    from repro_torch import bridge
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (ContinuousBatchingEngine, Request,
                                           engine_or_windowed)

    dense = ModelConfig(name="tiny-qk", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=256, qk_norm=True, remat=False)
    moe = dense.with_(name="tiny-moe", qk_norm=False,
                      moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32))
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
    for cfg, weights in ((dense, tiny_params(dense, seed=0)),
                         (moe, port_weights(moe, seed=0))):
        for name, plan in (("mpai", qat.serve_plan(PartitionPlan.mpai(2))),
                           ("bf16", None)):
            streams = {}
            for where in (dev, torch.device("cpu")):
                params = bridge.to_torch(weights, where)
                eng = engine_or_windowed(params, cfg, plan=plan,
                                         device=where, **kw)
                if not isinstance(eng, ContinuousBatchingEngine):
                    raise AssertionError(f"{cfg.name}: engine_or_windowed "
                                         f"gave {type(eng).__name__}")
                streams[where.type] = serve(eng, trace, Request)
                if where.type == "cpu":
                    cpu_params, padded_len = params, eng.padded_prompt_len

            def top2_of(rid, t):
                prompt, out = trace[rid][1], streams["cpu"][rid]
                ctx = np.zeros(padded_len(len(prompt)), np.int32)
                ctx[-len(prompt):] = prompt
                ctx = np.concatenate([ctx, np.asarray(out[:t], np.int32)])
                logits = T.forward(cpu_params, cfg,
                                   torch.as_tensor(ctx[None]),
                                   plan).logits[0, -1].float()
                return torch.topk(logits, 2).values
            ties = near_tie_divergences(f"{cfg.name} {name}", streams, trace,
                                        top2_of)
            emit("tiny_engine", plan=name, config=cfg.name,
                 requests=len(trace),
                 tokens=sum(len(s) for s in streams["cuda"].values()),
                 streams_equal=len(trace) - ties, near_tie_divergences=ties)


def kernel_wrappers() -> dict:
    """Every kernel wrapper, by its row name in the ``kernels`` line."""
    from repro_torch.kernels import (flash_attention, int8_matmul,
                                     paged_attention, quant, selective_scan,
                                     wkv)
    return {"paged_attention": paged_attention.paged_attention,
            "int8_matmul": int8_matmul.int8_matmul,
            "flash_attention": flash_attention.flash_attention,
            "wkv": wkv.wkv,
            "selective_scan": selective_scan.selective_scan,
            "rowwise_quant": quant.rowwise_quant}


class Int8Shapes:
    """Counts the (M, K, N) of every int8 GEMM the model calls while it is
    entered, by standing in for ``ops.int8_matmul`` (the model's call
    site); the wrapper's own launch count is untouched."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.real = ops, ops.int8_matmul
        self.counts = collections.Counter()

    def __enter__(self):
        def counted(x, w):
            self.counts[(x.shape[0], x.shape[1], w.shape[1])] += 1
            return self.real(x, w)
        self.ops.int8_matmul = counted
        return self

    def __exit__(self, *exc):
        self.ops.int8_matmul = self.real

    def emit(self, config: str, plan: str) -> None:
        emit("int8_gemm_shapes", config=config, plan=plan,
             launches=sum(self.counts.values()),
             shapes=[{"M": m, "K": k, "N": n, "launches": c}
                     for (m, k, n), c in sorted(self.counts.items())])


def zero_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def drive_windowed(server, trace, request_cls, logits=None) -> dict:
    """Serve ``trace`` to the end through a windowed server, one step at a
    time; returns ``{rid: tokens}``.  With ``logits`` (a list that the
    model's calls append their last-position logits to), also returns, per
    request, the logits row behind each of its tokens."""
    for rid, prompt, max_new in trace:
        server.submit(request_cls(rid, prompt, max_new=max_new))
    behind, window, steps = {}, [], 0
    while server.pending:
        if server.occupancy == 0:            # this step starts a window
            window = [r.rid for r in server.queue[:server.max_batch]]
            t = 0
        before = len(logits) if logits is not None else 0
        server.step()
        if logits is not None and len(logits) > before:
            for row, rid in enumerate(window):
                behind.setdefault(rid, {})[t] = logits[-1][row]
        t += 1
        steps += 1
        if steps > 10_000:
            raise AssertionError("windowed server made no progress")
    out = {rid: server.done[rid].output.tolist() for rid, _, _ in trace}
    return (out, behind) if logits is not None else out


def tiny_windowed_phase(dev) -> None:
    """Tiny stacks through ``engine_or_windowed``'s windowed fallback on
    CUDA (the kernels) and on the CPU (their plain versions), same bridged
    weights, same trace: equal greedy streams, unless the CPU logits are a
    near-tie where they part.  ``rwkv6-smoke`` (wkv), ``jamba-smoke``
    (selective scan, flash attention, MoE), and the tiny dense stack with a
    sliding window that bites (ring cache), with int8 KV (the fused int8 KV
    write) and with both (its ring slots)."""
    from repro_torch import bridge
    from repro_torch.configs.jamba_v0_1_52b import SMOKE as JAMBA
    from repro_torch.configs.rwkv6_3b import SMOKE as RWKV
    from repro_torch.configs.tiny import TINY
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (Request, WindowedBaselineServer,
                                           engine_or_windowed)

    wrappers = kernel_wrappers()
    # each config and the kernels its CUDA run must launch
    cases = ((RWKV, ("wkv",)),
             (JAMBA, ("selective_scan", "flash_attention")),
             (TINY.with_(name="tiny-window", sliding_window=4), ()),
             (TINY.with_(name="tiny-int8kv", kv_cache_dtype="int8"),
              ("rowwise_quant", "flash_attention")),
             (TINY.with_(name="tiny-int8kv-window", kv_cache_dtype="int8",
                         sliding_window=4), ("rowwise_quant",)))
    kw = dict(max_slots=3, prompt_len=8, max_len=20)
    real_prefill, real_decode = T.prefill, T.decode_step
    for cfg, kernels in cases:
        weights = port_weights(cfg, seed=0)
        rng = np.random.default_rng(6)
        trace = [(rid, rng.integers(0, cfg.vocab_size,
                                    int(rng.integers(1, 9))).astype(np.int32),
                  max_new)
                 for rid, max_new in enumerate([5, 0, 8, 1, 3, 7, 2])]
        for name, plan in (("mpai", qat.serve_plan(
                PartitionPlan.mpai(cfg.num_layers))), ("bf16", None)):
            streams = {}
            for side, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
                fallbacks = []
                srv = engine_or_windowed(bridge.to_torch(weights, where), cfg,
                                         plan=plan,
                                         on_fallback=fallbacks.append,
                                         device=where, **kw)
                if not (isinstance(srv, WindowedBaselineServer)
                        and len(fallbacks) == 1):
                    raise AssertionError(f"{cfg.name}: got "
                                         f"{type(srv).__name__} and "
                                         f"fallbacks {fallbacks}")
                if side == "cuda":
                    zero_counts()
                    streams["cuda"] = drive_windowed(srv, trace, Request)
                    idle = [k for k in kernels if not wrappers[k].launches]
                    if idle:
                        raise AssertionError(f"tiny windowed {cfg.name}: no "
                                             f"launch of {idle}")
                    continue
                logits = []

                def keep(fn):
                    def call(*a, **k):
                        out = fn(*a, **k)
                        logits.append(out.logits[:, -1].float())
                        return out
                    return call
                T.prefill = keep(real_prefill)
                T.decode_step = keep(real_decode)
                try:
                    streams["cpu"], behind = drive_windowed(srv, trace,
                                                            Request, logits)
                finally:
                    T.prefill, T.decode_step = real_prefill, real_decode
            ties = near_tie_divergences(
                f"tiny windowed {cfg.name} {name}", streams, trace,
                lambda rid, t: torch.topk(behind[rid][t], 2).values)
            emit("tiny_windowed", plan=name, config=cfg.name,
                 requests=len(trace),
                 tokens=sum(len(s) for s in streams["cuda"].values()),
                 streams_equal=len(trace) - ties, near_tie_divergences=ties)


def rwkv_full_width_phase(dev, card: str, wk, im, fa) -> dict:
    """RWKV-6 3B at full width and depth through ``engine_or_windowed``'s
    windowed fallback, under "mpai" and bf16.  Returns each kernel's
    launches in each plan's run, counted from 0."""
    from repro_torch.configs.rwkv6_3b import FULL
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (Request, WindowedBaselineServer,
                                           engine_or_windowed)

    cfg = FULL
    t0 = time.perf_counter()
    params = T.model_init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    emit("rwkv_full_width_init", config=cfg.name,
         seconds=time.perf_counter() - t0,
         param_gb=torch.cuda.memory_allocated(dev) / 1e9)
    rng = np.random.default_rng(7)
    top = RWKV_SERVE["prompt_len"]                    # prompts of 2..128
    room = RWKV_SERVE["max_len"] - top                # max_new of 1..32
    trace = []
    for rid in range(12):
        n = top if rid == 5 else int(rng.integers(2, top + 1))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        trace.append((rid, prompt,
                      1 if rid == 2 else int(rng.integers(1, room + 1))))
    warm = [(-1, np.array([1, 2, 3], np.int32), 2)]

    launches = {"wkv": {}, "int8_matmul": {}}
    mpai = qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
    for name, plan in (("mpai", mpai), ("bf16", None)):
        # keep the engine's refusal, not its traceback: the frames would
        # hold the 12.4 GB of weights past this phase
        fallbacks = []
        srv = engine_or_windowed(
            params, cfg, plan=plan, device=dev, **RWKV_SERVE,
            on_fallback=lambda e: fallbacks.append(e.with_traceback(None)))
        if not (isinstance(srv, WindowedBaselineServer) and len(fallbacks) == 1
                and isinstance(fallbacks[0], ValueError)):
            raise AssertionError(f"rwkv6-3b: engine_or_windowed gave "
                                 f"{type(srv).__name__}, fallbacks "
                                 f"{fallbacks}")
        drive_windowed(srv, warm, Request)    # first-use costs
        srv.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        windows = -(-len(trace) // srv.max_batch)
        zero_counts()                         # the main path's counts
        t0 = time.perf_counter()
        with Int8Shapes() as shapes:
            out = drive_windowed(srv, trace, Request)
        wall = time.perf_counter() - t0
        shapes.emit(cfg.name, name)
        wk_n, im_n = wk.wkv.launches, im.int8_matmul.launches
        fa_n = fa.flash_attention.launches
        launches["wkv"][f"{cfg.name}/{name}"] = wk_n
        launches["int8_matmul"][f"{cfg.name}/{name}"] = im_n
        for rid, _, max_new in trace:
            toks = out[rid]
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
                raise AssertionError(f"rwkv {name}: request {rid} returned "
                                     f"{toks} for max_new={max_new}")
        if wk_n != cfg.num_layers * windows:
            raise AssertionError(f"rwkv {name}: {wk_n} wkv launches for "
                                 f"{windows} prefill windows")
        if (im_n > 0) != (name == "mpai") or fa_n:
            raise AssertionError(f"rwkv {name}: {im_n} int8_matmul and "
                                 f"{fa_n} flash_attention launches")
        st = srv.stats()
        steps = st["decode_steps"]
        emit("rwkv_full_width_serve", plan=name, card=card, config=cfg.name,
             requests=len(trace), tokens=st["total_tokens"],
             windows=windows, decode_steps=steps,
             decode_tok_s=st["decode_tokens"] / st["decode_s"],
             mean_step_ms=st["decode_s"] / steps * 1e3,
             prefill_tokens=st["prefill_tokens"], wall_s=wall,
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             wkv_launches=wk_n, int8_matmul_launches=im_n)
        del srv
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated(dev) > 2 ** 30:
        raise AssertionError(f"rwkv phase left "
                             f"{torch.cuda.memory_allocated(dev) / 1e9} GB "
                             f"allocated")
    return launches


def jamba_full_width_phase(dev, card: str) -> dict:
    """Jamba-v0.1 at full width, one super-block (8 layers) deep, through
    ``engine_or_windowed``'s windowed fallback, under "mpai", bf16 and
    "mpai" with int8 KV.  Returns each kernel's launches in each run,
    counted from 0."""
    from repro_torch.configs.jamba_v0_1_52b import FULL
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import (Request, WindowedBaselineServer,
                                           engine_or_windowed)

    cfg = FULL.with_(num_layers=JAMBA_LAYERS)
    pat = T.sublayer_pattern(cfg)
    n_mamba = sum(kind == "mamba" for kind, _ in pat)
    n_attn = sum(kind == "attention" for kind, _ in pat)
    t0 = time.perf_counter()
    params = T.model_init(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    emit("jamba_full_width_init", config=cfg.name, layers=cfg.num_layers,
         params=cfg.param_count(), seconds=time.perf_counter() - t0,
         param_gb=torch.cuda.memory_allocated(dev) / 1e9)
    rng = np.random.default_rng(11)
    top = JAMBA_SERVE["prompt_len"]                   # prompts of 2..128
    room = JAMBA_SERVE["max_len"] - top               # max_new of 1..32
    trace = []
    for rid in range(12):
        n = top if rid == 5 else int(rng.integers(2, top + 1))
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        trace.append((rid, prompt,
                      1 if rid == 2 else int(rng.integers(1, room + 1))))
    warm = [(-1, np.array([1, 2, 3], np.int32), 2)]

    wrappers = kernel_wrappers()
    launches = {k: {} for k in wrappers}
    mpai = qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
    runs = (("mpai", cfg, mpai), ("bf16", cfg, None),
            ("mpai_int8kv", cfg.with_(kv_cache_dtype="int8"), mpai))
    for name, run_cfg, plan in runs:
        # keep the engine's refusal, not its traceback: the frames would
        # hold the weights past this phase
        fallbacks = []
        srv = engine_or_windowed(
            params, run_cfg, plan=plan, device=dev, **JAMBA_SERVE,
            on_fallback=lambda e: fallbacks.append(e.with_traceback(None)))
        if not (isinstance(srv, WindowedBaselineServer) and len(fallbacks) == 1
                and isinstance(fallbacks[0], ValueError)):
            raise AssertionError(f"jamba: engine_or_windowed gave "
                                 f"{type(srv).__name__}, fallbacks "
                                 f"{fallbacks}")
        drive_windowed(srv, warm, Request)    # first-use costs
        srv.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        windows = -(-len(trace) // srv.max_batch)
        zero_counts()                         # the main path's counts
        t0 = time.perf_counter()
        with Int8Shapes() as shapes:
            out = drive_windowed(srv, trace, Request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shapes.emit(cfg.name, name)
        got = {k: w.launches for k, w in wrappers.items()}
        for k, v in got.items():
            launches[k][f"{cfg.name}/{name}"] = v
        for rid, _, max_new in trace:
            toks = out[rid]
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
                raise AssertionError(f"jamba {name}: request {rid} returned "
                                     f"{toks} for max_new={max_new}")
        st = srv.stats()
        steps = st["decode_steps"]
        want = {"selective_scan": n_mamba * windows,
                "flash_attention": n_attn * windows,
                # one fused k-and-v write per prefill and decode step
                "rowwise_quant": (n_attn * (windows + steps)
                                  if run_cfg.kv_cache_dtype == "int8" else 0),
                "paged_attention": 0, "wkv": 0}
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad or (got["int8_matmul"] > 0) != (plan is not None):
            raise AssertionError(f"jamba {name}: launches (got, want) {bad}, "
                                 f"int8_matmul {got['int8_matmul']}")
        emit("jamba_full_width_serve", plan=name, card=card,
             config=cfg.name, layers=cfg.num_layers,
             kv_cache_dtype=run_cfg.kv_cache_dtype, requests=len(trace),
             tokens=st["total_tokens"], windows=windows, decode_steps=steps,
             decode_tok_s=st["decode_tokens"] / st["decode_s"],
             mean_step_ms=st["decode_s"] / steps * 1e3,
             prefill_tokens=st["prefill_tokens"], wall_s=wall,
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             **{f"{k}_launches": v for k, v in got.items()})
        del srv
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.memory_allocated(dev) > 2 ** 30:
        raise AssertionError(f"jamba phase left "
                             f"{torch.cuda.memory_allocated(dev) / 1e9} GB "
                             f"allocated")
    return launches


def full_width_phase(dev, card: str, pa, im, fa) -> dict:
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
    kw = QWEN_SERVE
    warm = [(-1, np.array([1, 2, 3], np.int32), 2),
            (-2, np.arange(1, 41, dtype=np.int32), 2)]

    launches = {"paged_attention": {}, "int8_matmul": {},
                "flash_attention": {}}
    mpai = qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
    for name, plan in (("mpai", mpai), ("bf16", None)):
        eng = ContinuousBatchingEngine(params, cfg, plan=plan, device=dev,
                                       **kw)
        serve(eng, warm, Request)     # first-use costs (cuBLAS, allocator)
        eng.reset_stats()
        # every admission round is one bucket prefill: one flash launch
        # per attention layer (chunked admissions attend through the pool)
        rounds = []
        eng.on_stage = lambda stage, *a: rounds.append(stage)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()                 # the main path's counts start here
        t0 = time.perf_counter()
        with Int8Shapes() as shapes:
            out = serve(eng, trace, Request)
        wall = time.perf_counter() - t0
        shapes.emit(cfg.name, name)
        pa_n, im_n = pa.paged_attention.launches, im.int8_matmul.launches
        fa_n = fa.flash_attention.launches
        launches["paged_attention"][f"{cfg.name}/{name}"] = pa_n
        launches["int8_matmul"][f"{cfg.name}/{name}"] = im_n
        launches["flash_attention"][f"{cfg.name}/{name}"] = fa_n
        admit_rounds = rounds.count("admit")
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
        if fa_n != cfg.num_layers * admit_rounds or not admit_rounds:
            raise AssertionError(f"{name}: {fa_n} flash_attention launches "
                                 f"for {admit_rounds} admission rounds")
        emit("full_width_serve", plan=name, card=card, requests=len(trace),
             tokens=st["total_tokens"], decode_steps=steps,
             decode_tok_s=st["decode_tokens"] / st["decode_s"],
             mean_step_ms=st["decode_s"] / steps * 1e3,
             admit_s=st["admit_s"], wall_s=wall,
             mean_occupancy=st["mean_occupancy"],
             deferrals=st["deferrals"],
             shared_block_hits=st["shared_block_hits"],
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             admission_rounds=admit_rounds, paged_attention_launches=pa_n,
             int8_matmul_launches=im_n, flash_attention_launches=fa_n)
        del eng
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant as rq
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import wkv as wk

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sm_mhz = int(float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]))
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=card,
         max_sm_mhz=sm_mhz, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    reports = build.build()
    ptxas = [ln.strip() for text in reports.values()
             for ln in text.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=build.sources(),
         ptxas=ptxas)

    timer = Timer(dev)
    rows = [paged_attention_phase(timer, pa, dev),
            int8_matmul_phase(timer, im, dev),
            flash_attention_phase(timer, fa, dev),
            wkv_phase(timer, wk, dev),
            selective_scan_phase(timer, ss, dev, sm_mhz),
            rowwise_quant_phase(timer, rq, dev)]
    del timer
    tiny_phase(dev)
    tiny_windowed_phase(dev)
    launches = {row["name"]: {} for row in rows}
    for phase in (lambda: rwkv_full_width_phase(dev, card, wk, im, fa),
                  lambda: jamba_full_width_phase(dev, card),
                  lambda: full_width_phase(dev, card, pa, im, fa)):
        for name, by_plan in phase().items():
            launches[name].update(by_plan)
    for row in rows:
        # each (config, plan) run is a main path, counted from 0 on its
        # own; "launches" is their sum, "launches_by_plan" keeps them apart
        row["launches_by_plan"] = launches[row["name"]]
        row["launches"] = sum(launches[row["name"]].values())
        if row["name"] in ("selective_scan", "rowwise_quant") and \
                not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on the main path")
    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
