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
bf16, and then, on the same weights, through the serving facade: the
fleet JSON ``FLEET_SPEC`` (an "mpai" and a bf16 engine pool at once, and
a cost-model pool) built with ``repro_torch.serving.FleetSpec`` and
driven by a seeded open loop of 12 greedy requests with the flight
recorder on, each kernel's launches held to the recorder's decode-step
and admission spans. The tiny fleet of ``tests/test_torch_facade_engine.py``
runs on CUDA and on the CPU before it (same admissions, equal greedy
streams). Each full-width engine run also prints the histogram of the
``(M, K, N)`` shapes its int8 GEMMs took.

Sampling and hardening: the threefry key stream and ``sample_logits`` on
the card against the CPU at Qwen3's vocabulary (``sampling``); the tiny
dense stack with half its requests sampled, plain and hardened with a
stalled slot and an armed bit flip, on CUDA and on the CPU; the Qwen3-14B
trace with half its requests sampled and, under bf16, hardened with no
fault, with a bit flip and with a stalled slot, each held to the
unfaulted streams (``qwen_sampled_hardened``: under "mpai" only the
counters, books and budgets, as int8 activations are quantized across the
batch); and the fleet again with a ``kv_bitflip`` on its bf16 pool, a
``slot_stall`` on its "mpai" pool and half its requests sampled
(``fleet_sampled_hardened``).  Launch counts include replayed decode calls
and bucket re-prefills.

Co-processing: the seam scenarios of ``tests/test_torch_disagg.py`` on the
tiny dense stack on CUDA and on the CPU (``tiny_coproc``); the Qwen3-14B
weights and trace through ``CoProcServer``, an "mpai" prefill engine
feeding two bf16 decode shards, every handoff through the wire
(``coproc_full_width``: each handoff's wire bytes and ms, one shard, a
corrupted and a lost handoff, a bit flip restored through the seam, all
held bit-equal to the two-shard run, and a bf16-prefill split against the
unified bf16 engine under the near-tie rule); and the split as a facade
pool with a ``handoff_loss`` fault (``fleet_coproc``); launches held to
the prefill chunks, decode steps and replays, flash never.

UrsoNet pose (the paper's Table I workload): ``tests/test_pose_qat.py``'s
network on CUDA against the CPU, the forward under the four serve pairs
and three ``train_step``s (``tiny_pose``); then ``run_condition`` for each
of the four conditions at ``configs/ursonet.FULL`` (50 steps of 16, 8 eval
batches), with LOCE, ORIE, train-step ms and eval images/s per condition,
the int8 GEMM launched 3 times an eval batch of the int8-head conditions,
those evaluations bit-equal to the same run on ``int8_matmul_plain``, and
the kernel bit-equal to its plain version at the heads' shapes
(``ursonet_full_width``).

The orbit control plane and the launchers: ``vision_orbit`` runs the orbit
and dashboard launchers at the reference's defaults (cost-model pools, no
model) and holds their reports to the reference's (``VISION_ORBIT_DIGESTS``);
``orbit_full_width`` serves the Qwen3-14B weights through ``ORBIT_SPEC`` (the
fleet's two engine pools, its cost-model pool and a priority-1 class) under
the port's eclipse orbit sized to the fleet's measured batch time, with an
autoscaler on the bf16 pool, and checks the mode leaving nominal and coming
back, deferrals completing after their defer spans (none of priority 1), a
clone added and retired, every request accounted for, the launches held to
the spans, and the Chrome trace, spans, Prometheus and SLO-report exports;
``orbit_storm`` runs the same fleet with a full battery and a ``kv_bitflip``,
the storm ladder flooring the mode at conserve; ``launch_serve`` runs
``python -m repro_torch.launch.serve --arch qwen3-14b --plan mpai --requests
16`` at full width once the other Qwen3 phases have freed their weights.
LM training: ``kernel_flash_backward`` holds the flash-attention
backward kernel to its plain version (autograd of the plain forward) at
Qwen3's layout (S 32 and 2048), StableLM-2's (S 4096, B 1 and 4) and a
ragged S in f32, twice bit-equal, timed beside SDPA's backward;
``tiny_train`` trains ``tiny_dense`` on CUDA and on the CPU;
``train_full_width`` trains StableLM-2 1.6B at full width (24 layers,
remat) on 4 x 4096 tokens (``train_4k``'s batch of 256 cut to 4), 4 steps
under bf16 and 4 under "mpai", with step ms, tokens/s, peak memory and
the flash kernels' launches, then a fault-tolerant run (a fault at step
2, a checkpoint every 2 steps, 1 layer deep) bit-equal to the
uninterrupted one; ``train_sharded`` trains the same full-width model
through the mesh ``Trainer`` (``fsdp=True``) in a one-rank NCCL group,
its history and parameters bit-equal to the one-device run's, and
``train_sharded_2rank`` trains it 2 layers deep on two gloo ranks sharing
the card, on the (2, 1) and (1, 2) meshes, held to the one-rank run and
restoring a (2, 1) checkpoint on (1, 1) and (1, 2); then the same two
ranks train OLMoE-1B-7B at full width, 1 layer deep (64 experts, top 8),
2 ``"mpai"`` steps (and 2 bf16 ones) of a 2 x 512 global batch on (2,
1), each rank routing its row inside the global batch
(``olmoe_sharded_2rank``: loss, aux loss, grad norm, gradients, dispatch
paths and dropped slots held to the one-rank run from its state; each
later step also run freely, beside where the parameters parted); and
RWKV-6 3B and Jamba's Mamba layers (no experts), each at full width, 2
layers deep, 2 f32, 2 ``"mpai"`` and 2 bf16 steps of 2 x 512 on (1, 2),
the mixers head-parallel (``rwkv_sharded_2rank``, ``mamba_sharded_2rank``:
wkv and its backward at 20 of 40 heads, the scan and its backward at
4096 of 8192 channels; loss, grad norm and gradient slices held to the
one-rank run, tightly in f32, RWKV-6's gradient in f32 alone);
the dry run traces the (1, 2) runs (``dryrun_two_rank``; the recurrent
runs' ``"mpai"`` ones);
``launch_train``
runs ``python -m repro_torch.launch.train --steps 2 --smoke`` at
``musicgen-medium``,
``jamba-v0.1-52b`` (the scan, flash and their backwards, the MoE
gradients) and ``rwkv6-3b``.
Recurrent training: ``kernel_wkv_backward`` and
``kernel_selective_scan_backward`` hold the two backward kernels to their
plain versions (the wkv at one RWKV-6 3B training layer, B 4 x S 4096 x 40
heads of 64; the scan at Jamba's full-width layer, d_inner 8192, N 16, at
the forward's shapes; both, and their forwards, also at a (1, 2) rank's
heads and channels, ``TP_WKV`` and ``TP_SCAN``), twice bit-equal;
``rwkv_train_full_width`` trains RWKV-6 3B at full width and depth (32 layers, remat) on ``RWKV_TRAIN_SHAPE``
3 steps under bf16 and 3 under "mpai", the wkv forward and its backward in
every layer, then repeats one step from the same state two layers deep,
bit-equal (``rwkv_train_repeat``).
The MPAI stage axis: ``staged_full_width`` serves the Qwen3-14B weights
through ``StageAxisEngine``, the fake-quantized int8 backbone and the bf16
tail as two pipeline stages on the one card, each on its own stream (6
greedy requests, two held to the monolithic forward's argmax, flash launched
once a layer, slot and step, the int8 GEMM never, the engine's stage
parameters views of the weights), then times one step's
``pipeline_apply`` on two streams against its stages on one stream
(bit-equal); ``fleet_staged`` serves a ``pipeline_stages=2`` pool through
``FleetSpec.build``; ``compression`` runs ``compressed_grad_mean`` over a
one-rank NCCL group on a 64 M-element leaf (its own round trip, bit for
bit).
Tooling and the examples: ``fleetlint`` runs the port's static analyzer
(``repro_torch.analysis``) over the checkout and fails unless it is clean,
prints its counts by pass, and resolves every kernel contract's
``extern "C"`` symbol with ``build.entry`` in the ``sm_90a`` libraries
just built, its argtypes those of the contract; ``examples`` runs the
five twins of ``examples_torch/`` in-process on the card at the
examples' own widths (``serve_partitioned``: Qwen3 smoke width, 4 layers,
an "mpai" prefill stage and 2 decode shards; ``quickstart``: its reduced
StableLM-2 config, 50 steps; ``train_100m``: d 640, 12 layers, vocab
50304, 8 x 512 tokens, 30 steps with the fault at step 25, bit-equal to an
uninterrupted run; ``route_failover`` and ``orbit_eclipse``: cost-model
fleets), each checked as the reference example asserts, its launches
counted under ``examples/<twin>`` in ``launches_by_plan``.
Prints one JSON line per phase,
the card's name and power limit, a ``{"kernels": [...]}`` line, and as its
last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; it also exits non-zero where there is no CUDA device.
Needs one card with 80 GB (the Qwen3-14B f32 weights take 59 GB, Jamba's
53 GB; each phase frees its weights before the next one makes its own).
"""
from __future__ import annotations

import collections
import contextlib
import gc
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's peaks and every kernel's work: bound_ms comes from them
from repro_torch import roofline  # noqa: E402

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
WKV_BWD_SRC = "src/repro_torch/kernels/csrc/wkv_bwd.cu"
SELECTIVE_SCAN_BWD_SRC = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
# no TPU counterpart: the reference differentiates XLA's scans
WKV_BWD_REPLACES = "src/repro/models/rwkv.py:115"
SELECTIVE_SCAN_BWD_REPLACES = "src/repro/models/mamba.py:72"

# The RWKV-6 3B serving shape: windows of 8 requests, prompts left-padded
# to 128 tokens (the wkv kernel's S), room for 32 new tokens.
RWKV_SERVE = dict(max_slots=8, prompt_len=128, max_len=160)
# Jamba-v0.1 is served at the RWKV shape: windows of 8, S = 128 for the
# selective scan and the flash kernel, decode against a 160-slot KV cache.
JAMBA_SERVE = RWKV_SERVE
JAMBA_LAYERS = 8          # one super-block: 1 attention + 7 Mamba layers
# RWKV-6 3B training: train_4k's 4096-token sequences, its batch of 256
# cut to what one card holds with f32 masters, AdamW moments and gradients
RWKV_TRAIN_SHAPE = (4096, 4)     # seq, batch
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
# (M, K, N) of the example twins' int8 GEMMs: serve_partitioned's Qwen3
# smoke decode (4 slots) and quickstart's StableLM-2 smoke evaluation (a
# batch of 8 x 64 tokens)
EXAMPLE_GEMMS = ((4, 64, 32), (4, 64, 64), (4, 64, 128), (4, 128, 64),
                 (512, 128, 128), (512, 128, 256), (512, 256, 128))
# (M, K, N) of StableLM-2's int8 GEMMs on a rank of the head-parallel
# "mpai" forward (``tp_forward``, 2 x 512 tokens, tp 2): column-parallel
# wq / wk / wv and w_in / w_gate at N / 2, row-parallel wo and w_out at
# K / 2
TP_GEMMS = ((1024, 2048, 1024), (1024, 1024, 2048), (1024, 2048, 2816),
            (1024, 2816, 2048))
# the recurrent kernels on a rank of the head-parallel (1, 2) runs of
# ``rwkv_sharded_2rank`` and ``mamba_sharded_2rank`` (2 x 512 tokens):
# RWKV-6 3B's wkv and its backward at 20 of its 40 heads of 64 (B 2),
# Jamba's scan and its backward at 4096 of its 8192 channels (B 1: Jamba's
# grad_accum 2 splits the two rows)
TP_WKV = (2, 512, 20)            # B, S, H
TP_SCAN = (1, 512, 4096)         # B, S, d_inner


def emit(phase: str, **kv) -> None:
    """One JSON line; ``clock_s`` (the host's monotonic clock) dates it, so
    two lines' difference is the time between them."""
    print(json.dumps({"phase": phase, **kv, "clock_s": time.perf_counter()}),
          flush=True)


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


# Paged decode attention: (label, lengths, pool blocks, geometry) of the
# Qwen3-14B decode layer (8 slots, table width 8 for max_len 128, a
# 64-block pool; KVp 8, gp 5, hd 128, P 16), of 8 sequences of 4096 tokens
# and of one, and of the example twins' decode steps: serve_partitioned's
# Qwen3 smoke width (4 slots, a 12-block pool of P 8, table width 3) and
# quickstart's StableLM-2 smoke width (2 slots, 4 blocks, table width 2)
QWEN_GEOM = dict(page=16, kvp=8, gp=5, hd=128)
PAGED_CASES = (("qwen3 decode layer", [0, 1, 16, 17, 40, 77, 127, 128], 64,
                QWEN_GEOM),
               ("B=8 x 4096", [4096] * 8, 0, QWEN_GEOM),
               ("B=1 x 4096", [4096], 0, QWEN_GEOM),
               ("serve_partitioned decode", [23, 17, 9, 0], 12,
                dict(page=8, kvp=2, gp=2, hd=16)),
               ("quickstart decode", [15, 0], 4,
                dict(page=8, kvp=4, gp=1, hd=32)))


def paged_attention_phase(timer, pa, dev) -> dict:
    """The paged-decode kernel against its plain version at ``PAGED_CASES``,
    each also as a CUDA graph replay (``device_ms``)."""
    rows = {}
    for seed, (label, lengths, num_blocks, geom) in enumerate(PAGED_CASES):
        args = paged_case(dev, lengths, seed, num_blocks, **geom)
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
        bound = roofline.kernel_bound(
            "paged_attention", b=b, kvp=kvp, gp=gp, hd=hd, page=page,
            table=tbl.numel(), blocks=int((-(-ln // page)).sum()),
            tokens=int(ln.sum()))
        rows[label] = {
            "max_abs_err": err, "bit_identical": True,
            "plan": pa.plan(b, kvp, mb, torch.cuda.get_device_properties(
                dev).multi_processor_count)._asdict(),
            "ms": timer.ms(lambda: pa.paged_attention(*args)),
            "device_ms": timer.device_ms(lambda: pa.paged_attention(*args)),
            "plain_ms": timer.ms(lambda: pa.paged_attention_plain(*args),
                                 reps=3 if mb > 8 else 15),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
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
    slots) and at a full admission bucket (M = 8 x 32), RWKV-6's and
    Jamba's widths at a window prefill (M = 8 x 128), the example
    twins' smoke widths (``EXAMPLE_GEMMS``) and a head-parallel rank's
    (``TP_GEMMS``); times it per shape beside
    ``torch._int_mm`` (at M <= 16 on x padded with zero rows to
    ``INT_MM_PAD_M``: ``_int_mm`` refuses M <= 16)."""
    g = torch.Generator(device=dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [(m, k, n) for m in (8, 8 * 32)
              for k, n in sorted(set(QWEN_LAYER_GEMMS))]
    shapes += [(8 * 128, k, n) for k, n in WINDOW_GEMMS]
    shapes += list(EXAMPLE_GEMMS) + list(TP_GEMMS)
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
        bound = roofline.kernel_bound("int8_matmul", m=m, k=k, n=n)
        t_bytes, t_ops = bound["bytes_ms"], bound["operations_ms"]
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
             bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
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


# (B, S, KVp, gp, hd) of the example twins' attention: quickstart's
# StableLM-2 smoke width (training and evaluation at 8 x 64, the served
# prompt at 2 slots x 8) and train_100m's d 640 (8 x 512)
EXAMPLE_FLASH = ((8, 64, 4, 1, 32), (2, 8, 4, 1, 32), (8, 512, 5, 2, 64))
# (B, S, KVp, gp, hd) of OLMoE-1B-7B's attention on each of the two ranks
# of ``olmoe_sharded_2rank`` (one row of the 2 x 512 global batch, 16 heads
# of 128)
OLMOE_FLASH = (1, 512, 16, 1, 128)
# (B, S, KVp, gp, hd) on a rank of the head-parallel (1, 2) runs: a
# StableLM-2 training microbatch (2 x 4096, 16 of the 32 heads), the
# "mpai" serving forward (``tp_forward``, 2 x 512) and OLMoE-1B-7B's step
# (2 x 512, 8 of the 16 heads)
TP_FLASH = ((2, 4096, 16, 1, 64), (2, 512, 16, 1, 64), (2, 512, 8, 1, 128))
# (B, S, KVp, gp, hd) on a rank of the per-block (2, 1) run
# (``layer_gather_2rank``: one row of the 2 x 512 global batch, StableLM-2's
# 32 heads of 64), under bf16 and f32
LAYER_GATHER_FLASH = (1, 512, 32, 1, 64)


def flash_attention_phase(timer, fa, dev) -> dict:
    """The causal flash kernel against its plain version at the Qwen3-14B
    admission round (B = 8 slots, S = prompt_len = 32, KVp = 8, gp = 5,
    hd = 128), at Jamba's attention prefill (B = 8, S = 128, gp = 4), at a
    2048-token Qwen3 prefill, at a ragged S, and at the example twins'
    shapes (``EXAMPLE_FLASH``) and the two-rank runs' (``OLMOE_FLASH``,
    ``TP_FLASH``, ``LAYER_GATHER_FLASH``, the last also in f32); beside
    each, one ``scaled_dot_product_attention`` call at the same shapes
    (timed only here: the port never calls it)."""
    g = torch.Generator(device=dev).manual_seed(4)
    rows, errs = {}, []
    cases = [(*c, torch.bfloat16) for c in (
        (QWEN_SERVE["max_slots"], QWEN_SERVE["prompt_len"], 8, 5, 128),
        (JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"], 8, 4, 128),
        (1, 2048, 8, 5, 128), (2, 301, 8, 5, 128), *EXAMPLE_FLASH,
        OLMOE_FLASH, *TP_FLASH, LAYER_GATHER_FLASH)]
    for b, s, kvp, gp, hd, dt in cases + [(*LAYER_GATHER_FLASH,
                                           torch.float32)]:
        q = torch.randn((b, s, kvp, gp, hd), generator=g, device=dev).to(dt)
        k = torch.randn((b, s, kvp, hd), generator=g, device=dev).to(dt)
        v = torch.randn((b, s, kvp, hd), generator=g, device=dev).to(dt)
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
        size = q.element_size()
        flops, _, _ = roofline.kernel_work("flash_attention", b=b, s=s,
                                           kvp=kvp, gp=gp, hd=hd,
                                           itemsize=size)
        bound = roofline.kernel_bound("flash_attention", b=b, s=s, kvp=kvp,
                                      gp=gp, hd=hd, itemsize=size)
        rows[(b, s, kvp, gp, hd, dt)] = {
            "ms": timer.ms(lambda: fa.flash_attention(q, k, v)),
            "device_ms": timer.device_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": timer.ms(lambda: fa.flash_attention_plain(q, k, v)),
            "library_ms": lib_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "bound_f32_cuda_core_ms": flops / roofline.PEAK_F32 * 1e3,
            "max_abs_err": err}
        emit("kernel_flash_attention", B=b, S=s, KVp=kvp, gp=gp, hd=hd,
             dtype=str(dt).split(".")[-1], **rows[(b, s, kvp, gp, hd, dt)],
             library_note=lib_note, tolerance="2**-6 * |ref| + 2**-10",
             bound_peak=("bf16 tensor cores, 989 TFLOP/s" if size == 2
                         else "f32, 67 TFLOP/s"))
    adm = rows[(QWEN_SERVE["max_slots"], QWEN_SERVE["prompt_len"], 8, 5,
                128, torch.bfloat16)]
    return {"name": "flash_attention", "route": "cuda",
            "source": FLASH_ATTENTION_SRC, "replaces": FLASH_ATTENTION_TPU,
            "launches": 0, "max_abs_err": max(errs),
            **{k: adm[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")},
            "shapes": "one admission layer of Qwen3-14B: B=8 S=32 KVp=8 "
                      "gp=5 hd=128; bound on bf16 tensor cores"}


def wkv_phase(timer, wk, dev) -> dict:
    """The wkv kernel against its plain version, output and final state,
    at the RWKV-6 3B prefill window (B = 8, S = 128, H = 40, N = 64), at a
    ragged S and at one 2048-token prompt; two launches must agree bit for
    bit."""
    g = torch.Generator(device=dev).manual_seed(5)
    n = 64
    rows, errs = {}, []
    for b, s, h in ((RWKV_SERVE["max_slots"], RWKV_SERVE["prompt_len"], 40),
                    (3, 37, 40), (1, 2048, 40), TP_WKV):
        mk = lambda: torch.randn((b, s, h, n), generator=g, device=dev)
        r, k, v = mk(), mk(), mk()
        w = torch.exp(-torch.exp(mk() - 1))
        u = torch.randn((h, n), generator=g, device=dev)
        y, s_fin = wk.wkv(r, k, v, w, u)
        y2, s_fin2 = wk.wkv(r, k, v, w, u)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(s_fin, s_fin2)):
            raise AssertionError(f"wkv: two launches differ at B={b} S={s} "
                                 f"H={h}")
        y_p, s_p = wk.wkv_plain(r, k, v, w, u)
        # f32 recurrences summed in two orders (fma chain vs einsum)
        err_y, ok_y = within(y, y_p, 1e-4, 1e-4)
        err_s, ok_s = within(s_fin, s_p, 1e-4, 1e-4)
        if not (ok_y and ok_s):
            raise AssertionError(f"wkv disagrees with its plain version at "
                                 f"B={b} S={s} H={h}: max |err| y {err_y}, "
                                 f"state {err_s}")
        errs.append(max(err_y, err_s))
        bound = roofline.kernel_bound("wkv", b=b, s=s, h=h, n=n)
        rows[(b, s, h)] = {
            "ms": timer.ms(lambda: wk.wkv(r, k, v, w, u)),
            "device_ms": timer.device_ms(lambda: wk.wkv(r, k, v, w, u)),
            "plain_ms": timer.ms(lambda: wk.wkv_plain(r, k, v, w, u),
                                 reps=3 if s > 512 else 15),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "max_abs_err_y": err_y, "max_abs_err_state": err_s,
            "bit_identical": True}
        emit("kernel_wkv", B=b, S=s, H=h, N=n, **rows[(b, s, h)],
             library_ms=None, tolerance="1e-4 * |ref| + 1e-4",
             **({"shape_of": "a (1, 2) rank of rwkv_sharded_2rank"}
                if (b, s, h) == TP_WKV else {}))
    main = rows[(RWKV_SERVE["max_slots"], RWKV_SERVE["prompt_len"], 40)]
    return {"name": "wkv", "route": "cuda", "source": WKV_SRC,
            "replaces": WKV_TPU, "launches": 0, "max_abs_err": max(errs),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": f"one RWKV-6 3B prefill layer: B=8 S=128 H={h} N={n}"}


# (B, S, d_inner) of the selective scan (N 16): the Jamba prefill window,
# a ragged B and S, one 2048-token prompt, each at Jamba's 8192 channels
SCAN_SHAPES = ((JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"], 8192),
               (3, 37, 8192), (1, 2048, 8192))


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
    n = 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, errs = {}, []
    for b, s, dim in SCAN_SHAPES + (TP_SCAN,):
        args = scan_case(dev, b, s, g, dim, n)
        x, bm, a = args[0], args[2], args[4]
        y, h = ss.selective_scan(*args)
        y2, h2 = ss.selective_scan(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"selective_scan: two launches differ at "
                                 f"B={b} S={s} D={dim}")
        y_p, h_p = ss.selective_scan_plain(*args)
        # f32 recurrences: an exp and fma chain against exp and einsum
        err_y, ok_y = within(y, y_p, 1e-4, 1e-4)
        err_h, ok_h = within(h, h_p, 1e-4, 1e-4)
        if not (ok_y and ok_h):
            raise AssertionError(f"selective_scan disagrees with its plain "
                                 f"version at B={b} S={s} D={dim}: max "
                                 f"|err| y {err_y}, state {err_h}")
        errs.append(max(err_y, err_h))
        # the exps on the special-function unit: 16 a clock per SM
        bound = roofline.kernel_bound("selective_scan",
                                      sfu_per_s=16 * sms * sm_mhz * 1e6,
                                      b=b, s=s, dim=dim, n=n)
        rows[(b, s, dim)] = {
            "ms": timer.ms(lambda: ss.selective_scan(*args)),
            "device_ms": timer.device_ms(lambda: ss.selective_scan(*args)),
            "plain_ms": timer.ms(lambda: ss.selective_scan_plain(*args),
                                 reps=3 if s > 512 else 15),
            **bound,
            "lanes": ss.plan(b, dim, n, sms),
            "max_abs_err_y": err_y, "max_abs_err_state": err_h,
            "bit_identical": True}
        emit("kernel_selective_scan", B=b, S=s, D=dim, N=n,
             **rows[(b, s, dim)], library_ms=None,
             tolerance="1e-4 * |ref| + 1e-4",
             **({"shape_of": "a (1, 2) rank of mamba_sharded_2rank"}
                if (b, s, dim) == TP_SCAN else {}))
    main = rows[(JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"], 8192)]
    dim = 8192
    return {"name": "selective_scan", "route": "cuda",
            "source": SELECTIVE_SCAN_SRC, "replaces": SELECTIVE_SCAN_TPU,
            "launches": 0, "max_abs_err": max(errs),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "shapes": f"one Jamba Mamba prefill layer: B=8 S=128 D={dim} "
                      f"N={n}; the exps bound on the special-function "
                      f"unit at {sm_mhz} MHz"}


# per gradient of a backward kernel: ||err|| <= BWD_FRO * ||ref|| and max
# |err| <= BWD_MAX * max |ref| (f32 recurrences walked in the same order;
# the scan's exps are ex2.approx against exp)
BWD_FRO, BWD_MAX = 1e-5, 1e-4


def plain_ms(fn):
    """(result, device ms) of one call of a plain version, by CUDA events
    (the plain walks run thousands of small launches: one call is timed)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def grads_agree(what: str, names, got, want) -> float:
    """Max |err| over the gradients ``got`` against ``want``; raises where
    one is not finite or outside ``BWD_FRO`` / ``BWD_MAX``."""
    worst = 0.0
    for name, g, w in zip(names, got, want):
        err = g.float() - w.float()
        ok = (bool(torch.isfinite(g).all())
              and torch.linalg.norm(err) <= BWD_FRO * torch.linalg.norm(w)
              and err.abs().max() <= BWD_MAX * w.abs().max())
        if not ok:
            raise AssertionError(f"{what} {name} disagrees with its plain "
                                 f"version: max |err| {err.abs().max()}")
        worst = max(worst, err.abs().max().item())
    return worst


def wkv_backward_phase(timer, wk, dev) -> dict:
    """The wkv backward kernel against its plain version at one RWKV-6 3B
    training layer (``RWKV_TRAIN_SHAPE``, 40 heads of 64) and at a ragged S
    with the final state's gradient; two launches bit-equal.  ``ms`` around
    the wrapper, ``device_ms`` a graph replay of one call; the plain
    version timed once (it walks S steps of small launches);
    ``forward_ms`` the forward kernel writing the checkpoints, as training
    launches it."""
    g = torch.Generator(device=dev).manual_seed(11)
    n = 64
    seq, batch = RWKV_TRAIN_SHAPE
    rows, errs = {}, []
    for b, s, h, with_ds in ((batch, seq, 40, False), (2, 37, 40, True),
                             (*TP_WKV, False)):
        mk = lambda: torch.randn((b, s, h, n), generator=g, device=dev)
        r, k, v, dy = mk(), mk(), mk(), mk()
        w = torch.exp(-torch.exp(mk() - 1))
        u = torch.randn((h, n), generator=g, device=dev)
        ds = (torch.randn((b, h, n, n), generator=g, device=dev)
              if with_ds else None)
        _, _, ckpt = wk._launch(r, k, v, w, u, checkpoints=True)
        call = lambda: wk.wkv_bwd(r, k, v, w, u, ckpt, dy, ds)
        got, again = call(), call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"wkv_bwd: two launches differ at B={b} "
                                 f"S={s} H={h}")
        del again
        want, p_ms = plain_ms(lambda: wk.wkv_bwd_plain(r, k, v, w, u, dy,
                                                       ds))
        errs.append(grads_agree(f"wkv_bwd B={b} S={s} H={h}",
                                ("dr", "dk", "dv", "dw", "du"), got, want))
        del got, want
        bound = roofline.kernel_bound("wkv_bwd", b=b, s=s, h=h, n=n,
                                      ds_fin=with_ds)
        rows[(b, s, h)] = {
            "ms": timer.ms(call, reps=5 if s > 512 else 15),
            "device_ms": timer.device_ms(call, reps=5 if s > 512 else 15),
            "forward_ms": timer.ms(lambda: wk._launch(
                r, k, v, w, u, checkpoints=True)),
            "plain_ms": p_ms, **bound,
            "max_abs_err": errs[-1], "bit_identical": True}
        emit("kernel_wkv_backward", B=b, S=s, H=h, N=n, ds_fin=with_ds,
             **rows[(b, s, h)], plan=wk.bwd_plan(s, n)._asdict(),
             resident_clusters=wk.bwd_clusters(b, s, h, n), library_ms=None,
             tolerance=f"per gradient ||err|| <= {BWD_FRO} ||ref||, max "
                       f"|err| <= {BWD_MAX} max |ref|",
             **({"shape_of": "a (1, 2) rank of rwkv_sharded_2rank"}
                if (b, s, h) == TP_WKV else {}))
        del r, k, v, w, dy, ckpt
    torch.cuda.empty_cache()
    main = rows[(batch, seq, 40)]
    h = 40
    return {"name": "wkv_bwd", "route": "cuda", "source": WKV_BWD_SRC,
            "replaces": WKV_BWD_REPLACES, "launches": 0,
            "max_abs_err": max(errs),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "replaces_note": "no TPU counterpart: the reference trains "
                             "through XLA's autodiff of _wkv_chunk_scan",
            "shapes": f"one RWKV-6 3B training layer: B={batch} S={seq} "
                      f"H={h} N={n}"}


def selective_scan_backward_phase(timer, ss, dev, sm_mhz: int) -> dict:
    """The selective-scan backward kernel against its plain version at
    Jamba's full-width layer (d_inner 8192, N 16) at ``SCAN_SHAPES`` (the
    forward's rows), the ragged one with the final state's gradient; two
    launches bit-equal; timed as the wkv backward (``forward_ms`` the
    forward writing the checkpoints)."""
    g = torch.Generator(device=dev).manual_seed(12)
    n = 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, errs = {}, []
    for b, s, dim in SCAN_SHAPES + (TP_SCAN,):
        args = scan_case(dev, b, s, g, dim, n)
        x, bm, a = args[0], args[2], args[4]
        dy = torch.randn((b, s, dim), generator=g, device=dev)
        dh = (torch.randn((b, dim, n), generator=g, device=dev)
              if (b, s) == (3, 37) else None)
        _, _, ckpt = ss._launch(*args, checkpoints=True)
        call = lambda: ss.selective_scan_bwd(*args, ckpt, dy, dh)
        got, again = call(), call()
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError(f"selective_scan_bwd: two launches differ "
                                 f"at B={b} S={s} D={dim}")
        del again
        want, p_ms = plain_ms(lambda: ss.selective_scan_bwd_plain(
            *args, dy, dh))
        errs.append(grads_agree(f"selective_scan_bwd B={b} S={s} D={dim}",
                                ("dx", "ddt", "dB", "dC", "dA", "dD"), got,
                                want))
        del got, want
        bound = roofline.kernel_bound("selective_scan_bwd",
                                      sfu_per_s=16 * sms * sm_mhz * 1e6,
                                      b=b, s=s, dim=dim, n=n,
                                      dh_fin=dh is not None)
        rows[(b, s, dim)] = {
            "ms": timer.ms(call), "device_ms": timer.device_ms(call),
            "forward_ms": timer.ms(lambda: ss._launch(
                *args, checkpoints=True)),
            "plain_ms": p_ms, **bound,
            "max_abs_err": errs[-1], "bit_identical": True}
        emit("kernel_selective_scan_backward", B=b, S=s, D=dim, N=n,
             dh_fin=dh is not None, **rows[(b, s, dim)],
             plan=ss.bwd_plan(b, s, dim, n, sms)._asdict(), library_ms=None,
             tolerance=f"per gradient ||err|| <= {BWD_FRO} ||ref||, max "
                       f"|err| <= {BWD_MAX} max |ref|",
             **({"shape_of": "a (1, 2) rank of mamba_sharded_2rank"}
                if (b, s, dim) == TP_SCAN else {}))
        del args, dy, ckpt
    main = rows[(JAMBA_SERVE["max_slots"], JAMBA_SERVE["prompt_len"], 8192)]
    dim = 8192
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": SELECTIVE_SCAN_BWD_SRC,
            "replaces": SELECTIVE_SCAN_BWD_REPLACES, "launches": 0,
            "max_abs_err": max(errs),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None,
            "replaces_note": "no TPU counterpart: the reference trains "
                             "through XLA's autodiff of _chunk_scan",
            "shapes": f"one Jamba Mamba layer at full width: B=8 S=128 "
                      f"D={dim} N={n}; the exps bound on the "
                      f"special-function unit at {sm_mhz} MHz"}


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
            bound = roofline.kernel_bound("rowwise_quant", m=m, k=k,
                                          itemsize=x.element_size())
            row = {"ms": timer.ms(lambda: rq.rowwise_quant(x)),
                   "device_ms": timer.device_ms(lambda: rq.rowwise_quant(x)),
                   "plain_ms": timer.ms(lambda: rq.rowwise_quant_plain(x)),
                   "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"]}
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
        bound = roofline.kernel_bound(
            "rowwise_quant_into", elements=k.numel(),
            itemsize=k.element_size(),
            written=k.shape[0] * min(s, t) * k.shape[2], hd=k.shape[-1])
        fused = lambda: rq.rowwise_quant_into(k, v, *bufs, slot)
        seq = lambda: kv_write_sequence(rq, k, v, bufs, slot)
        row = {"ms": timer.ms(fused), "device_ms": timer.device_ms(fused),
               "plain_ms": timer.ms(
                   lambda: rq.rowwise_quant_into_plain(k, v, *plain, slot)),
               "sequence_ms": timer.ms(seq),
               "sequence_device_ms": timer.device_ms(seq),
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
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


SAMPLING_SEEDS = (0, 1, 42, -1, -7, 2**31 - 1, -2**31, 9)
QWEN_VOCAB = 151936


def sampling_phase(timer, dev) -> None:
    """The key stream and the sampler on the card against the CPU: keys
    and threefry bits equal exactly on a grid of seeds (negative ones
    included) and step indices (past ``2**31`` too); ``sample_logits`` on
    ``[8, 151936]`` f32 logits equal for temperature {0, 0.7, 1.0} x top_k
    {0, 1, 50}, unless the CPU's top two of ``gumbel + scaled`` are a
    near-tie; then the device ms of ``sample_logits`` and of the plain
    argmax the greedy path runs, on the bf16 logits a Qwen3 decode step
    gives its 8 rows."""
    from repro_torch.core import prng
    from repro_torch.runtime.sampling import SamplingParams, sample_logits

    cpu = torch.device("cpu")
    steps = torch.tensor([0, 1, 5, 31, 2**31 - 1, 2**31, 2**32 - 1])
    for seed in SAMPLING_SEEDS:
        seeds = torch.full(steps.shape, seed, dtype=torch.int32)
        keys = {d.type: prng.fold_in(prng.threefry_seed(seeds.to(d)),
                                     steps.to(d)) for d in (dev, cpu)}
        if not torch.equal(keys["cuda"].cpu(), keys["cpu"]):
            raise AssertionError(f"sampling: seed {seed}: keys differ")
        for shape in ((1,), (7,), (QWEN_VOCAB,)):
            bits = [prng.random_bits(keys[k], shape).cpu()
                    for k in ("cuda", "cpu")]
            if not torch.equal(*bits):
                raise AssertionError(f"sampling: seed {seed}, shape "
                                     f"{shape}: threefry bits differ")
    gen = torch.Generator().manual_seed(11)
    logits = torch.randn((8, QWEN_VOCAB), generator=gen) * 4
    seeds = torch.tensor(SAMPLING_SEEDS, dtype=torch.int32)
    steps = torch.arange(8, dtype=torch.int32) * 977
    ties = compared = 0
    for temp in (0.0, 0.7, 1.0):
        for top_k in (0, 1, 50):
            args = (logits, torch.full((8,), temp), torch.full(
                (8,), top_k, dtype=torch.int32), seeds, steps)
            want = sample_logits(*args)
            got = sample_logits(*(a.to(dev) for a in args)).cpu()
            compared += 8
            for row in torch.nonzero(got != want).flatten().tolist():
                top2 = (torch.topk(logits[row], 2).values if temp == 0
                        else perturbed_top2(
                            logits[row], SamplingParams(temp, top_k,
                                                        int(seeds[row])),
                            int(steps[row])))
                margin = float(top2[0] - top2[1])
                if margin > 2 ** -20 * max(1.0, abs(float(top2[0]))):
                    raise AssertionError(
                        f"sampling: temperature {temp}, top_k {top_k}, row "
                        f"{row}: token {int(got[row])} on the card, "
                        f"{int(want[row])} on the CPU, margin {margin}")
                ties += 1
    x = (torch.randn((8, QWEN_VOCAB), device=dev) * 4).bfloat16()
    knobs = (torch.ones(8, device=dev),
             torch.tensor([0, 50] * 4, dtype=torch.int32, device=dev),
             seeds.to(dev), steps.to(dev))
    emit("sampling", rows=8, vocab=QWEN_VOCAB, seeds=len(SAMPLING_SEEDS),
         samples_compared=compared, near_tie_divergences=ties,
         sample_logits_ms=timer.ms(lambda: sample_logits(x, *knobs)),
         sample_logits_device_ms=timer.device_ms(
             lambda: sample_logits(x, *knobs)),
         argmax_ms=timer.ms(lambda: torch.argmax(x, dim=-1)),
         argmax_device_ms=timer.device_ms(lambda: torch.argmax(x, dim=-1)))


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


def serve(engine, trace, request_cls, sampling=None, faults=()) -> dict:
    """Serve ``trace`` ((rid, prompt, max_new) triples) to the end through
    an engine; ``sampling`` maps rids to their ``SamplingParams`` (greedy
    where absent), ``faults`` are (step, method, argument) calls on the
    engine made before that step (``arm_bitflip``, ``stall_slot``, ...).
    Returns ``{rid: tokens}``."""
    sampling = sampling or {}
    for rid, prompt, max_new in trace:
        engine.submit(request_cls(rid, prompt, max_new=max_new,
                                  sampling=sampling.get(rid)))
    steps = 0
    while engine.pending:
        for at, method, arg in faults:
            if at == steps:
                getattr(engine, method)(arg)
        engine.step()
        steps += 1
        if steps > 10_000:
            raise AssertionError("engine made no progress")
    return {rid: engine.done[rid].output.tolist() for rid, _, _ in trace}


class StageLog:
    """The engine's device calls, from its ``on_stage`` spans: what its
    kernels' launch counts must be.  Paged attention runs once a layer in
    every decode step and every replayed decode call (a replay of ``g``
    tokens makes ``g - 1``, which ``decode_steps`` does not count); flash
    attention once a layer in every bucket prefill: each admission round,
    and each replay whose prompt fits the bucket (a longer one re-prefills
    in chunks, which attend through the pool)."""

    def __init__(self, engine, trace):
        self.engine, self.stages = engine, []
        self.prompt = {rid: len(p) for rid, p, _ in trace}
        engine.on_stage = lambda stage, t0, t1, rids, attrs: \
            self.stages.append((stage, list(rids), attrs))

    def count(self, stage: str) -> int:
        return sum(1 for st, _, _ in self.stages if st == stage)

    def expected(self) -> tuple:
        """(paged attention calls, flash attention calls) a layer."""
        replays = [(rids[0], attrs["tokens"])
                   for st, rids, attrs in self.stages if st == "replay"]
        decode = self.count("decode_step") + sum(max(g - 1, 0)
                                                 for _, g in replays)
        prefill = self.count("admit") + sum(
            1 for rid, _ in replays
            if self.prompt[rid] <= self.engine.prompt_len)
        return decode, prefill

    def check(self, what: str, layers: int, launches: dict) -> None:
        decode, prefill = self.expected()
        pa_n, fa_n = launches["paged_attention"], launches["flash_attention"]
        if pa_n != layers * decode or not decode:
            raise AssertionError(f"{what}: {pa_n} paged_attention launches "
                                 f"for {decode} decode calls")
        if fa_n != layers * prefill or not prefill:
            raise AssertionError(f"{what}: {fa_n} flash_attention launches "
                                 f"for {prefill} bucket prefills")


class CoProcLog:
    """A ``CoProcServer``'s device calls, from its ``on_stage`` spans: the
    prefill engine's ``prefill_chunk`` and ``handoff``, the shards'
    ``import``, ``decode_step`` and ``replay`` (tagged with their shard).
    Paged attention runs once a layer in every shard decode step and every
    replayed decode call; flash attention never (every prefill is chunked
    and attends through the pool); the int8 GEMM only in the prefill
    chunks of an "mpai" prefill stage, the same number in each."""

    def __init__(self, server):
        self.spans = []
        server.on_stage = lambda stage, t0, t1, rids, attrs: \
            self.spans.append((stage, t0, t1, list(rids), attrs))

    def count(self, stage: str) -> int:
        return sum(1 for sp in self.spans if sp[0] == stage)

    def decode_calls(self) -> int:
        return self.count("decode_step") + sum(
            max(sp[4]["tokens"] - 1, 0) for sp in self.spans
            if sp[0] == "replay")

    def ms(self, stage: str) -> dict:
        """Each rid's last ``stage`` span, in ms (host wall time)."""
        return {sp[3][0]: (sp[2] - sp[1]) * 1e3 for sp in self.spans
                if sp[0] == stage}

    def check(self, what: str, layers: int, launches: dict,
              int8_per_chunk: int) -> None:
        decode, chunks = self.decode_calls(), self.count("prefill_chunk")
        pa_n, fa_n = launches["paged_attention"], launches["flash_attention"]
        im_n = launches["int8_matmul"]
        if pa_n != layers * decode or not decode:
            raise AssertionError(f"{what}: {pa_n} paged_attention launches "
                                 f"for {decode} decode calls")
        if fa_n:
            raise AssertionError(f"{what}: {fa_n} flash_attention launches "
                                 f"in a split run")
        if im_n != int8_per_chunk * chunks or not chunks:
            raise AssertionError(f"{what}: {im_n} int8_matmul launches for "
                                 f"{chunks} prefill chunks of "
                                 f"{int8_per_chunk}")


class HandoffTimes:
    """Times every handoff's ``to_bytes`` (the device-to-host copy
    included) and ``from_bytes`` while entered, by standing in for
    ``PrefillHandoff``'s two methods (as ``Int8Shapes`` does for the int8
    GEMM's call site); each row also has the frame's bytes."""

    def __init__(self):
        from repro_torch.runtime import serve
        self.cls = serve.PrefillHandoff
        self.real_to = self.cls.__dict__["to_bytes"]
        self.real_from = self.cls.__dict__["from_bytes"]
        self.rows = []

    def __enter__(self):
        real_to, real_from, rows = self.real_to, self.real_from, self.rows

        def to_bytes(ho):
            t0 = time.perf_counter()
            wire = real_to(ho)
            rows.append({"rid": ho.rid, "bytes": len(wire),
                         "to_bytes_ms": (time.perf_counter() - t0) * 1e3})
            return wire

        def from_bytes(cls, buf):
            t0 = time.perf_counter()
            try:
                return real_from.__func__(cls, buf)
            finally:
                rows[-1]["from_bytes_ms"] = (time.perf_counter() - t0) * 1e3
        self.cls.to_bytes = to_bytes
        self.cls.from_bytes = classmethod(from_bytes)
        return self

    def __exit__(self, *exc):
        self.cls.to_bytes = self.real_to
        self.cls.from_bytes = self.real_from


def capture_top2(server) -> dict:
    """The top two logits behind every token a ``CoProcServer`` picks,
    ``{(rid, token index): values}``: the prefill engine's first tokens
    and the shards' decode picks (a recomputed first token of a muted
    handoff writes the same values again)."""
    store, cur = {}, {}
    pre = server.prefill
    real_handoff, real_first = pre.prefill_handoff, pre._pick

    def handoff(req):
        cur["rid"] = req.rid
        return real_handoff(req)

    def first(logits, *a, **k):
        store[(cur["rid"], 0)] = torch.topk(logits[0].float(), 2).values.cpu()
        return real_first(logits, *a, **k)
    pre.prefill_handoff, pre._pick = handoff, first
    for eng in server.decodes:
        def pick(logits, *a, _eng=eng, _real=eng._pick, **k):
            top = torch.topk(logits.float(), 2, dim=-1).values.cpu()
            for i, sl in enumerate(_eng.slots):
                if sl is not None:
                    store[(sl.req.rid, len(sl.gen))] = top[i]
            return _real(logits, *a, **k)
        eng._pick = pick
    return store


def launches_now(pa, im, fa) -> dict:
    return {"paged_attention": pa.paged_attention.launches,
            "int8_matmul": im.int8_matmul.launches,
            "flash_attention": fa.flash_attention.launches}


HARDENING = ("bitflips_detected", "blocks_quarantined", "watchdog_trips",
             "replays", "scrubbed_blocks")


def perturbed_top2(logits_row, sp, t: int):
    """The top two of ``gumbel + scaled`` behind token ``t`` of a request
    sampled with ``sp``: ``sample_logits``'s values for one row."""
    from repro_torch.core import prng
    l = logits_row.float()
    if sp.top_k > 0:
        kth = torch.sort(l, descending=True).values[min(sp.top_k,
                                                        l.numel()) - 1]
        l = torch.where(l < kth, float("-inf"), l)
    key = prng.fold_in(prng.threefry_seed(torch.tensor(sp.seed,
                                                       dtype=torch.int32)),
                       torch.tensor(t))
    temp = torch.tensor(max(float(np.float32(sp.temperature)), 1e-6))
    return torch.topk(prng.gumbel(key, l.shape) + l / temp, 2).values


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
    tiny_sampled_hardened(dev, dense, tiny_params(dense, seed=0), trace, kw)


# the sampled requests of the tiny trace, (temperature, top_k, seed) by
# rid: rids 2 and 5 admit by chunked prefill
TINY_SAMPLED = {2: (1.0, 0, 42), 3: (0.7, 8, -1), 5: (1.0, 50, 2**31 - 1),
                6: (2.0, 1, 7), 8: (0.5, 0, -2**31)}
# the tiny hardened run's faults: (engine step, method, argument)
TINY_FAULTS = ((2, "stall_slot", 1), (3, "arm_bitflip", 3),
               (15, "unstall_slot", 1))


def tiny_sampled_hardened(dev, cfg, weights, trace, kw) -> None:
    """The tiny dense stack with half its requests sampled, plain and
    hardened (``watchdog_steps=3``) with a stalled slot and an armed bit
    flip, on CUDA and on the CPU under "mpai" and bf16: equal streams
    (sampled ones part only where the CPU's top two of ``gumbel + scaled``
    are a near-tie), and in the hardened run equal hardening counters and
    allocator books; every kernel launch count as ``StageLog`` says."""
    from repro_torch import bridge
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as T
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.serve import ContinuousBatchingEngine, Request

    sampling = {rid: SamplingParams(t, k, seed)
                for rid, (t, k, seed) in TINY_SAMPLED.items()}
    for name, plan in (("mpai", qat.serve_plan(PartitionPlan.mpai(2))),
                       ("bf16", None)):
        for run, extra, faults in (("sampled", {}, ()),
                                   ("hardened", dict(harden=True,
                                                     watchdog_steps=3),
                                    TINY_FAULTS)):
            streams, books = {}, {}
            for where in (dev, torch.device("cpu")):
                params = bridge.to_torch(weights, where)
                eng = ContinuousBatchingEngine(params, cfg, plan=plan,
                                               device=where, **kw, **extra)
                log = StageLog(eng, trace)
                zero_counts()
                streams[where.type] = serve(eng, trace, Request, sampling,
                                            faults)
                st = eng.stats()
                books[where.type] = {
                    "counters": {k: st[k] for k in HARDENING},
                    "free": list(eng.alloc.free),
                    "quarantined": sorted(eng.alloc.quarantined)}
                if where.type == "cuda":
                    log.check(f"tiny {run} {name}", cfg.num_layers,
                              launches_now(pa, im, fa))
                else:
                    cpu_params, padded_len = params, eng.padded_prompt_len
            if books["cuda"] != books["cpu"]:
                raise AssertionError(f"tiny {run} {name}: hardening books "
                                     f"differ: {books}")
            c = books["cuda"]["counters"]
            if run == "hardened" and not (c["bitflips_detected"]
                                          and c["watchdog_trips"]):
                raise AssertionError(f"tiny hardened {name}: {c}")

            def top2_of(rid, t):
                prompt, out = trace[rid][1], streams["cpu"][rid]
                ctx = np.zeros(padded_len(len(prompt)), np.int32)
                ctx[-len(prompt):] = prompt
                ctx = np.concatenate([ctx, np.asarray(out[:t], np.int32)])
                logits = T.forward(cpu_params, cfg,
                                   torch.as_tensor(ctx[None]),
                                   plan).logits[0, -1].float()
                if rid in sampling:
                    return perturbed_top2(logits, sampling[rid], t)
                return torch.topk(logits, 2).values
            ties = near_tie_divergences(f"tiny {run} {name}", streams, trace,
                                        top2_of)
            emit("tiny_engine", plan=name, config=cfg.name, run=run,
                 requests=len(trace), sampled=len(sampling),
                 tokens=sum(len(s) for s in streams["cuda"].values()),
                 streams_equal=len(trace) - ties, near_tie_divergences=ties,
                 **books["cuda"]["counters"])


# the CPU test's scenarios the tiny split runs on CUDA and on the CPU
TINY_COPROC = ("two_shards", "corrupt_wire", "handoff_loss",
               "hardened_bitflip_bf16")


def tiny_coproc_phase(dev) -> None:
    """The co-processing scenarios of ``tests/test_torch_disagg.py`` (two
    decode shards; a corrupted wire frame; a lost handoff; hardened
    engines with a bit flip whose eviction comes back through the seam) on
    the tiny dense stack, on CUDA and on the CPU with the same weights:
    equal greedy streams unless the CPU's top two logits are a near-tie
    where they part, equal ``stats()`` and allocator books, and on CUDA
    every kernel launch as ``CoProcLog`` says."""
    from repro_torch import bridge
    from repro_torch.configs.tiny import TINY
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve import CoProcServer

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_disagg as case   # its scenarios, workload and drive

    weights = tiny_params(TINY, seed=0)
    for name in TINY_COPROC:
        sc = case.SCENARIOS[name]
        trace = case._requests(sc.get("requests", "disagg"))
        runs = {}
        for label, where in (("cuda", dev), ("cpu", torch.device("cpu"))):
            params = bridge.to_torch(weights, where)
            logs = []

            def server(pre, decs):
                co = CoProcServer(pre, decs)
                logs.append(CoProcLog(co))
                return co
            zero_counts()
            runs[label] = case._drive(
                case._port_pkg(params, where, server), sc)
            if label == "cuda":
                logs[0].check(f"tiny coproc {name}", TINY.num_layers,
                              launches_now(pa, im, fa), 0)
            else:
                cpu_params = params
        got, want = runs["cuda"], runs["cpu"]
        for key in ("stats", "books", "steps"):
            if got[key] != want[key]:
                raise AssertionError(f"tiny coproc {name}: {key} differ "
                                     f"between CUDA and the CPU: "
                                     f"{got[key]} vs {want[key]}")
        st = got["stats"]
        if name == "hardened_bitflip_bf16" and not (
                st["bitflips_detected"] and st["replays"]):
            raise AssertionError(f"tiny coproc {name}: {st}")
        if name in ("corrupt_wire", "handoff_loss") and \
                st["handoffs_replayed"] != 1:
            raise AssertionError(f"tiny coproc {name}: {st}")
        streams = {k: {int(r): t for r, t in v["outputs"].items()}
                   for k, v in runs.items()}

        def top2_of(rid, t):
            prompt = trace[rid][1]
            ctx = np.zeros(-(-max(len(prompt), case.PROMPT_LEN)
                             // case.PROMPT_LEN) * case.PROMPT_LEN, np.int32)
            ctx[-len(prompt):] = prompt
            ctx = np.concatenate([ctx, np.asarray(streams["cpu"][rid][:t],
                                                  np.int32)])
            logits = T.forward(cpu_params, TINY,
                               torch.as_tensor(ctx[None])).logits[0, -1]
            return torch.topk(logits.float(), 2).values
        ties = near_tie_divergences(f"tiny coproc {name}", streams, trace,
                                    top2_of)
        emit("tiny_coproc", scenario=name, config=TINY.name,
             requests=len(trace),
             tokens=sum(len(v) for v in streams["cuda"].values()),
             streams_equal=len(trace) - ties, near_tie_divergences=ties,
             **{k: st[k] for k in ("handoffs", "handoffs_lost",
                                   "handoffs_replayed", "imports_by_shard",
                                   *HARDENING)})


def kernel_wrappers() -> dict:
    """Every kernel wrapper, by its row name in the ``kernels`` line."""
    from repro_torch.kernels import (flash_attention, int8_matmul,
                                     paged_attention, quant, selective_scan,
                                     wkv)
    return {"paged_attention": paged_attention.paged_attention,
            "int8_matmul": int8_matmul.int8_matmul,
            "flash_attention": flash_attention.flash_attention,
            "flash_attention_bwd": flash_attention.flash_attention_bwd,
            "wkv": wkv.wkv,
            "wkv_bwd": wkv.wkv_bwd,
            "selective_scan": selective_scan.selective_scan,
            "selective_scan_bwd": selective_scan.selective_scan_bwd,
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
    """Every kernel wrapper's launch count to 0 (and the backward's count
    of each route)."""
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
        by_route = getattr(wrapper, "launches_by_route", None)
        if by_route is not None:
            by_route.update(dict.fromkeys(by_route, 0))


def launch_counts() -> dict:
    """Every kernel's launches by its row in the ``kernels`` line (the
    flash backward's by route)."""
    from repro_torch.kernels import flash_attention as fa
    n = {name: w.launches for name, w in kernel_wrappers().items()
         if name != "flash_attention_bwd"}
    return {**n, **train_launches(fa)}


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


def tiny_fleet_phase(dev) -> None:
    """The fleet of ``tests/test_torch_facade_engine.py`` (a cost-model
    pool, engine pools under "mpai" and bf16, a windowed pool), built from
    its JSON with the same tiny dense weights on CUDA and on the CPU, and
    driven by the same seeded open loop with the executors' clock pinned
    by the test's stub: the same admissions and serving pools, and equal
    greedy streams unless the CPU logits are a near-tie where they part."""
    from repro_torch import bridge
    from repro_torch.configs.tiny import TINY
    from repro_torch.models import transformer as T
    from repro_torch.serving import FleetSpec, LMWork, PoolSpec, executor

    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_facade_engine as case   # its fleet, payloads, clock

    text = json.dumps(case.fleet(FleetSpec, PoolSpec).to_dict())
    weights = tiny_params(TINY, seed=0)
    wrappers = kernel_wrappers()
    runs, real = {}, executor.time
    for where in (dev, torch.device("cpu")):
        params = bridge.to_torch(weights, where)
        executor.time = case.StubClock()
        try:
            client = FleetSpec.from_dict(json.loads(text)).build(
                model=(TINY, params), device=where)
            zero_counts()
            runs[where.type] = case.serve(client, LMWork)
        finally:
            executor.time = real
        if where.type == "cuda":
            idle = [k for k in ("paged_attention", "flash_attention",
                                "int8_matmul") if not wrappers[k].launches]
            if idle:
                raise AssertionError(f"tiny fleet: no launch of {idle}")
        else:
            cpu_params, cpu_client = params, client
    got, want = runs["cuda"]["handles"], runs["cpu"]["handles"]
    placed = [(h["rid"], h["admitted"], h["pool"]) for h in got]
    if placed != [(h["rid"], h["admitted"], h["pool"]) for h in want]:
        raise AssertionError("tiny fleet: admissions or pools differ between "
                             "CUDA and the CPU")
    prompts = {h["rid"]: np.asarray(p, np.int32) for h, p in
               zip(want[case.N_COST:], runs["cpu"]["prompts"])}
    trace = [(rid, None, None) for rid in prompts]
    streams = {"cuda": {h["rid"]: h["tokens"] for h in got},
               "cpu": {h["rid"]: h["tokens"] for h in want}}
    pool_of = {h["rid"]: h["pool"] for h in want}

    def top2_of(rid, t):
        srv, prompt = cpu_client.engines[pool_of[rid]], prompts[rid]
        pad = getattr(srv, "padded_prompt_len", None)
        ctx = np.zeros(pad(len(prompt)) if pad else srv.prompt_len, np.int32)
        ctx[-len(prompt):] = prompt
        ctx = np.concatenate([ctx, np.asarray(streams["cpu"][rid][:t],
                                              np.int32)])
        logits = T.forward(cpu_params, TINY, torch.as_tensor(ctx[None]),
                           srv.plan).logits[0, -1].float()
        return torch.topk(logits, 2).values
    ties = near_tie_divergences("tiny fleet", streams, trace, top2_of)
    pools = runs["cuda"]["snapshot"]["pools"]
    emit("tiny_fleet", config=TINY.name, requests=len(got),
         lm_requests=len(trace),
         tokens=sum(len(s) for s in streams["cuda"].values()),
         streams_equal=len(trace) - ties, near_tie_divergences=ties,
         batches={name: p["batches"] for name, p in sorted(pools.items())})


# The full-width fleet: two engine pools sized as QWEN_SERVE with chunked
# admission up to 64-token prompts, and a cost-model pool.  "lm-any"
# requests take the cheapest plan (int8: the "mpai" pool), "lm-accurate"
# ones bf16 plans (the bf16 pool), "exact" ones fp32 plans, which only the
# cost-model pool hosts.
FLEET_SPEC = {
    "pools": [
        {"name": name, "profiles": [profile], "backend": "engine",
         "plan": plan, "capacity": 1, "max_window": 8, "max_wait_s": 0.5,
         "max_slots": QWEN_SERVE["max_slots"],
         "prompt_len": QWEN_SERVE["prompt_len"],
         "block_size": QWEN_SERVE["block_size"], "max_prompt_len": 64,
         "max_new": 32}
        for name, profile, plan in (("qwen-mpai", "tpu_v5e_int8", "mpai"),
                                    ("qwen-bf16", "tpu_v5e_bf16", "bf16"))
    ] + [{"name": "vision", "profiles": ["tpu_v5e_fp32"], "capacity": 1,
          "max_window": 4}],
    "workload": "transformer", "dt": 0.01, "trace": True,
    "slos": [{"name": "lm-any", "max_latency_s": 600.0},
             {"name": "lm-accurate", "max_latency_s": 600.0,
              "max_accuracy_penalty": 0.02},
             {"name": "exact", "max_latency_s": 600.0,
              "max_accuracy_penalty": 0.0}],
}
FLEET_LM, FLEET_COST = 12, 4
# the faulted fleet and the split one serve 8 LM requests: their faults
# act at 0.05 s, on the first batches (``orbit_storm``'s bit flip does so
# on 8); the unfaulted fleet keeps 12, whose batch time sizes the orbit
FLEET_FAULTED_LM = 8
# the eclipse's autoscaler needs the load: two seconds of arrivals (24
# before the chip budget's trim) still queue past ``queue_high`` within the
# first batch, and outlast the battery's one second of demand
ORBIT_LM = 16
FLEET_RATE_HZ = 8.0
FLEET_MIX = (("lm-any", 0.5), ("lm-accurate", 0.5))


def fleet_full_width_phase(dev, card: str, cfg, params, pa, im, fa) -> dict:
    """Qwen3-14B at full width served through the facade: the fleet JSON
    above, built with ``FleetSpec.build(model=(cfg, params))`` on the card,
    a seeded open loop of 12 greedy requests (2-32 token prompts, two of
    40-64, ``max_new`` 1-32) over both engine pools at once, and cost-model
    requests to the third pool, with the flight recorder on.  Returns each
    kernel's launches in the run, counted from 0, and the engine pools'
    mean batch seconds."""
    return fleet_run(dev, card, cfg, params, (pa, im, fa), FLEET_SPEC,
                     "fleet_full_width", sampled=False)


# the same fleet with a data-plane fault on each engine pool (each then
# runs hardened): an upset in a live KV block of the bf16 pool, and a
# stalled slot of the "mpai" pool that its watchdog evicts
FLEET_FAULTS = [{"pool": "qwen-bf16", "at_s": 0.05, "kind": "kv_bitflip",
                 "seed": 3},
                {"pool": "qwen-mpai", "at_s": 0.05, "duration_s": 2.0,
                 "kind": "slot_stall", "slot": 0}]


def fleet_sampled_hardened_phase(dev, card: str, cfg, params, pa, im,
                                 fa) -> dict:
    """The fleet of ``fleet_full_width_phase`` with ``FLEET_FAULTS``,
    ``FLEET_FAULTED_LM`` LM requests and half of them sampled (temperature
    1, top_k 50, a seed each):
    completed + dropped == admitted, no orphan span, the bit flip and the
    watchdog trip reach the pools' counters in the snapshot, and each
    kernel's launches equal the recorder's decode-step, replay and
    admission spans say."""
    spec = {**FLEET_SPEC, "faults": FLEET_FAULTS}
    return fleet_run(dev, card, cfg, params, (pa, im, fa), spec,
                     "fleet_sampled_hardened", sampled=True,
                     n_lm=FLEET_FAULTED_LM)[0]


def fleet_coproc_phase(dev, card: str, cfg, params, kernels,
                       int8_per_chunk: int) -> dict:
    """Qwen3-14B at full width through the facade's co-processing split:
    ``FLEET_COPROC`` built with ``FleetSpec.build`` on the card, the
    seeded open loop of ``fleet_full_width_phase`` (greedy) cut to
    ``FLEET_FAULTED_LM`` LM requests, with the flight recorder on and a
    lost handoff: everything completes, the
    prefill stage pool has the prompt tokens and no decode token, the seam
    replayed, and the launches are the recorder's ``decode_step`` and
    ``replay`` spans' (paged attention) and ``prefill_chunk`` spans'
    (``int8_per_chunk`` int8 GEMMs each), with no flash launch."""
    return fleet_run(dev, card, cfg, params, kernels, FLEET_COPROC,
                     "fleet_coproc", sampled=False,
                     int8_per_chunk=int8_per_chunk,
                     n_lm=FLEET_FAULTED_LM)[0]


FAULT_COUNTER = {"kv_bitflip": "bitflips_detected",
                 "slot_stall": "watchdog_trips",
                 "handoff_loss": "handoffs_replayed"}


def fleet_run(dev, card: str, cfg, params, kernels, spec: dict, phase: str,
              sampled: bool, int8_per_chunk=None, n_lm: int = FLEET_LM,
              mix=FLEET_MIX, orbit=None) -> dict:
    """Build ``spec`` on the card over ``(cfg, params)``, drive the seeded
    open loop (``n_lm`` LM requests over the classes of ``mix``,
    ``FLEET_COST`` cost-model ones) with the flight recorder on, check the
    run and emit its lines; with ``sampled``, half the LM requests sample.
    A split pool's stage pool (``<pool>.prefill``) is checked and reported
    beside it, and with ``int8_per_chunk`` the int8 launches are held to
    its prefill chunks.  With ``orbit`` (an :class:`OrbitRun`) its
    controller is attached before the traffic, an idle tail follows it, the
    pools the autoscaler adds count as engine pools (their warm-up
    launches aside), and the orbit's own checks and exports close the run.
    Returns each kernel's launches in the run, counted from 0, and the
    engine pools' mean batch seconds (wall time, the virtual clock's)."""
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.serving import FleetSpec, LMWork, open_loop

    pa, im, fa = kernels
    t0 = time.perf_counter()
    client = FleetSpec.from_dict(json.loads(json.dumps(spec))).build(
        model=(cfg, params), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    budgets, prompt_lens, samples = [], [], []
    warm = collections.Counter()      # launches of live-added pools' warm-up
    if orbit is not None:
        orbit.attach(client)
        real_add = client.add_pool

        def add_pool(*a, **kw):
            before = launches_now(pa, im, fa)
            real_add(*a, **kw)
            warm.update({k: v - before[k]
                         for k, v in launches_now(pa, im, fa).items()})
        client.add_pool = add_pool    # the autoscaler's call

    def payload(rng):
        i = len(budgets)
        n = (int(rng.integers(40, 65)) if i in (4, 9)
             else int(rng.integers(2, 33)))
        budgets.append(int(rng.integers(1, 33)))
        prompt_lens.append(n)
        sp = None
        if sampled and rng.random() < 0.5:
            sp = SamplingParams(temperature=1.0, top_k=50,
                                seed=int(rng.integers(-2**31, 2**31)))
        samples.append(sp is not None)
        return LMWork(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                      max_new=budgets[-1], sampling=sp)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                     # the main path's counts start here
    t0 = time.perf_counter()
    cost = [client.submit(None, slo="exact") for _ in range(FLEET_COST)]
    handles = open_loop(client, [client.resolve_slo(c) for c, _ in mix],
                        [w for _, w in mix], rate_hz=FLEET_RATE_HZ,
                        n_requests=n_lm, seed=3, payload_fn=payload)
    if orbit is not None:
        for _ in range(orbit.tail_ticks):   # idle: clones drain and retire
            client.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = launches_now(pa, im, fa)
    served = {k: v - warm[k] for k, v in n.items()}
    snap = client.telemetry
    if handles.truncated:
        raise AssertionError(f"{phase}: the open loop was cut at its time "
                             f"limit")
    if snap["completed"] + snap["dropped"] != snap["admitted"]:
        raise AssertionError(f"{phase}: {snap['completed']} completed + "
                             f"{snap['dropped']} dropped != "
                             f"{snap['admitted']} admitted")
    prompt_of = {}
    for h, max_new, plen in zip(handles, budgets, prompt_lens):
        r = h.result()
        prompt_of[r.rid] = plen
        if not r.admitted or r.dropped:
            continue
        toks = r.tokens.tolist()
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"{phase}: request {r.rid} on {r.pool} "
                                 f"returned {toks} for max_new={max_new}")
    if any(h.result().pool != "vision" for h in cost):
        raise AssertionError(f"{phase}: a cost-model request left its pool")
    tracer = client.tracer
    if tracer.open_spans() or tracer.dropped:
        raise AssertionError(f"{phase}: {len(tracer.open_spans())} orphan "
                             f"spans, {tracer.dropped} dropped")
    counters = client.router.telemetry.pools
    built = [p["name"] for p in spec["pools"] if p.get("backend") == "engine"]
    clones = [name for name in counters
              if any(name.startswith(f"{p}/as") for p in built)]
    lm_pools = built + clones
    split = {p["name"] for p in spec["pools"]
             if p.get("prefill_backend") == "engine"}
    lanes = collections.Counter((sp.pool, sp.stage) for sp in tracer.spans)
    steps = sum(lanes[(p, "decode_step")] for p in lm_pools)
    admits = sum(lanes[(p, "admit")] for p in lm_pools)
    chunks = sum(lanes[(f"{p}.prefill", "prefill_chunk")] for p in split)
    replays = [sp for sp in tracer.spans if sp.stage == "replay"]
    replay_calls = sum(max(sp.attrs["tokens"] - 1, 0) for sp in replays)
    # a split pool restores through the seam (chunked): no bucket prefill
    reprefills = sum(1 for sp in replays if sp.pool not in split
                     and prompt_of[sp.rid] <= QWEN_SERVE["prompt_len"])
    if served["paged_attention"] != cfg.num_layers * (steps + replay_calls) \
            or not steps:
        raise AssertionError(f"{phase}: {served['paged_attention']} "
                             f"paged_attention launches for {steps} "
                             f"decode_step spans and {replay_calls} "
                             f"replayed decode calls")
    if served["flash_attention"] != cfg.num_layers * (admits + reprefills) \
            or not (admits or split):
        raise AssertionError(f"{phase}: {served['flash_attention']} "
                             f"flash_attention launches for {admits} admit "
                             f"spans and {reprefills} bucket re-prefills")
    if int8_per_chunk is not None:
        if served["int8_matmul"] != int8_per_chunk * chunks or not chunks:
            raise AssertionError(f"{phase}: {served['int8_matmul']} "
                                 f"int8_matmul launches for {chunks} "
                                 f"prefill_chunk spans of {int8_per_chunk}")
    elif not served["int8_matmul"]:
        raise AssertionError(f"{phase}: no int8_matmul launch")
    for f in spec.get("faults", ()):
        pool = snap["pools"][f["pool"]]
        key = FAULT_COUNTER[f["kind"]]
        if not pool[key] or pool[key] != getattr(counters[f["pool"]], key):
            raise AssertionError(f"{phase}: pool {f['pool']} reports "
                                 f"{key}={pool[key]}")
    for name in split:
        pre, dec = snap["pools"][f"{name}.prefill"], snap["pools"][name]
        if not pre["prefill_tokens"] or pre["decode_tokens"] \
                or dec["prefill_tokens"] or not dec["decode_tokens"]:
            raise AssertionError(f"{phase}: stage pools of {name} charged "
                                 f"prefill {pre['prefill_tokens']}/"
                                 f"{dec['prefill_tokens']}, decode "
                                 f"{pre['decode_tokens']}/"
                                 f"{dec['decode_tokens']} tokens")
    stages = [f"{p}.prefill" for p in sorted(split)]
    for name in lm_pools + stages + ["vision"]:
        pc = counters[name]
        # a stage pool is charged per request, not per batch; a clone the
        # autoscaler added may have retired before it took a batch
        if name not in clones and not (pc.completed if name in stages
                                       else pc.batches):
            raise AssertionError(f"{phase}: pool {name} served nothing")
        emit(f"{phase}_pool", pool=name, card=card,
             decode_tok_s=(pc.decode_tokens / pc.decode_s
                           if pc.decode_s else None),
             tokens=pc.tokens_generated, decode_tokens=pc.decode_tokens,
             requests=pc.completed, batches=pc.batches,
             decode_steps=lanes[(name, "decode_step")],
             admission_rounds=lanes[(name, "admit")],
             replays=lanes[(name, "replay")],
             prefill_tokens=pc.prefill_tokens, deferrals=pc.deferrals,
             busy_s=pc.busy_s, decode_s=pc.decode_s,
             bitflips_detected=pc.bitflips_detected,
             blocks_quarantined=pc.blocks_quarantined,
             watchdog_trips=pc.watchdog_trips,
             handoffs_replayed=pc.handoffs_replayed,
             imports_by_shard=dict(pc.imports_by_shard),
             prefill_chunks=lanes[(name, "prefill_chunk")],
             handoffs=lanes[(name, "handoff")],
             imports=lanes[(name, "import")])
    extra = ({} if orbit is None else
             orbit.finish(client, list(handles) + cost, wall))
    emit(phase, config=cfg.name, card=card,
         requests=len(handles) + len(cost), sampled=sum(samples),
         admitted=snap["admitted"], completed=snap["completed"],
         dropped=snap["dropped"], violations=snap["violations"],
         virtual_s=client.now, build_s=build_s, wall_s=wall,
         peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         spans=len(tracer.spans), replayed_decode_calls=replay_calls,
         bucket_reprefills=reprefills,
         **{f"{k}_launches": v for k, v in n.items()},
         **{f"{k}_warmup_launches": v for k, v in warm.items()}, **extra)
    batch_s = (sum(counters[p].busy_s for p in lm_pools)
               / max(sum(counters[p].batches for p in lm_pools), 1))
    del client, handles, cost
    return n, batch_s


# The orbit fleet: FLEET_SPEC's pools and classes and one LM class of
# priority 1, which the controller never defers (its default
# defer_max_priority is 0)
ORBIT_SPEC = {**FLEET_SPEC, "slos": FLEET_SPEC["slos"] + [
    {"name": "lm-critical", "max_latency_s": 600.0,
     "max_accuracy_penalty": 0.02, "priority": 1}]}
ORBIT_MIX = (("lm-any", 0.4), ("lm-accurate", 0.3), ("lm-critical", 0.3))
# an LM pool charges its plan's energy_j per decoded token: budgets of 1-32
# tokens decode 15.5 a request on average (the first comes from admission)
ORBIT_DECODED = 15.5
# The orbit: the first second sunlit, while the open loop's first eight
# arrivals come in, then an eclipse of two batch times T of the engine
# pools (a backlog outlives a batch), a battery of one second of demand
# (eight requests' worth), the reference's harvest margins; the autoscaler
# acts at most every quarter batch
ORBIT_SUNLIT_S, ORBIT_ECLIPSE_T, ORBIT_BUCKET_S = 1.0, 2.0, 1.0
ORBIT_COOLDOWN_T = 0.25
ORBIT_TAIL_S = 5.0          # idle virtual seconds after the open loop


class OrbitRun:
    """The orbit control plane over one ``fleet_run``: the port's
    ``eclipse_orbit_spec`` around the fleet's demand, in units of the
    fleet's measured batch time ``batch_s``, with an autoscaler on the bf16
    pool (``storm=False``); or a battery that never runs low with the
    storm ladder on (``storm=True``).  ``finish`` checks the run's orbit
    invariants and its four exports and emits its ``orbit`` line."""

    def __init__(self, phase: str, card: str, batch_s: float,
                 storm: bool = False):
        self.phase, self.card = phase, card
        self.batch_s, self.storm = batch_s, storm
        self.tail_ticks = int(round(ORBIT_TAIL_S / FLEET_SPEC["dt"]))

    def demand_w(self, client) -> float:
        """``mix_demand_w`` over ``ORBIT_MIX``, each class priced at the
        plan nominal dispatch picks for it (looked up on the client: the
        global ``SLO_CLASSES`` hold no ``lm-*`` class), per decoded
        token."""
        from repro_torch.router import select_plan
        per_req = 0.0
        for name, w in ORBIT_MIX:
            plan = select_plan(client.router.frontier,
                               client.resolve_slo(name),
                               latency_headroom=client.router.latency_headroom)
            if plan is not None:
                per_req += w * plan.energy_j * ORBIT_DECODED
        return FLEET_RATE_HZ * per_req

    def attach(self, client) -> None:
        from repro_torch.launch.orbit import eclipse_orbit_spec
        from repro_torch.orbit import OrbitSpec, PhaseSpec, ScalingPolicy
        demand = self.demand_w(client)
        t = self.batch_s
        if self.storm:
            # a battery of an hour's demand, charged at ten times it
            self.ospec = OrbitSpec(
                phases=[PhaseSpec("sunlit", 3600.0, 10 * demand)],
                bucket_j=3600.0 * demand, storm_events=1, storm_decay=0.9)
            sizing = {}
        else:
            # growth when a pool holds the arrivals of a quarter batch,
            # at most 4: admission prepays drain the battery below conserve
            # (where growth stops) within about a second of arrivals
            queue_high = min(4, max(2, int(round(FLEET_RATE_HZ * t / 4))))
            self.ospec = eclipse_orbit_spec(
                demand, sunlit_s=ORBIT_SUNLIT_S,
                eclipse_s=ORBIT_ECLIPSE_T * t, bucket_s=ORBIT_BUCKET_S,
                scaling=ScalingPolicy(template="qwen-bf16", min_pools=1,
                                      max_pools=2, queue_high=queue_high,
                                      queue_low=0,
                                      cooldown_s=ORBIT_COOLDOWN_T * t))
            sizing = {"queue_high": queue_high,
                      "cooldown_s": ORBIT_COOLDOWN_T * t}
        self.ctrl = self.ospec.attach(client)
        emit(f"{self.phase}_sizing", batch_s=t, demand_w_cost_model=demand,
             phases=[p.to_dict() for p in self.ospec.phases],
             bucket_j_cost_model=self.ospec.bucket_j,
             storm_events=self.ospec.storm_events, **sizing)

    def finish(self, client, handles, wall: float) -> dict:
        """Check the run and emit its ``orbit`` line; returns the exports'
        summary for the phase's line."""
        ctrl, tracer = self.ctrl, client.tracer
        snap = client.telemetry
        phase = self.phase
        modes = [m for _, m in ctrl.transitions]
        if self.storm:
            storms = [sp for sp in tracer.spans
                      if sp.stage == "mode" and sp.attrs["storm"]]
            if not storms or any(sp.attrs["mode"] != "conserve"
                                 or sp.attrs["bucket_frac"]
                                 <= self.ospec.conserve_frac
                                 for sp in storms):
                raise AssertionError(
                    f"{phase}: the storm ladder did not floor the mode at "
                    f"conserve on a full battery: "
                    f"{[sp.attrs for sp in storms]}")
        else:
            left = next((i for i, m in enumerate(modes) if m != "nominal"),
                        None)
            if modes[0] != "nominal" or left is None \
                    or "nominal" not in modes[left:]:
                raise AssertionError(f"{phase}: transitions {modes} do not "
                                     f"leave nominal and come back")
            if snap["energy_deferred"] < 1:
                raise AssertionError(f"{phase}: nothing was deferred")
            if snap["pools_added"] < 1 or \
                    snap["pools_retired"] != snap["pools_added"] or \
                    any("/as" in name for name in client.router.pools):
                raise AssertionError(
                    f"{phase}: {snap['pools_added']} pools added, "
                    f"{snap['pools_retired']} retired, fleet "
                    f"{sorted(client.router.pools)} at the end")
        by_rid = {h.rid: h for h in handles}
        for sp in tracer.spans:
            if sp.stage != "defer":
                continue
            h = by_rid[sp.rid]
            if h._rreq.slo.priority > ctrl.spec.defer_max_priority:
                raise AssertionError(f"{phase}: request {sp.rid} of "
                                     f"priority {h._rreq.slo.priority} "
                                     f"was deferred")
            r = h.result()
            if sp.t1 is None or r.dropped or not r.admitted or \
                    h._rreq.done_s < sp.t1:
                raise AssertionError(f"{phase}: deferred request {sp.rid} "
                                     f"did not complete after its defer "
                                     f"span ({sp.t1}, {h._rreq.done_s})")
        if any(not h.done for h in handles):
            raise AssertionError(f"{phase}: unresolved handles")
        if snap["completed"] + snap["dropped"] + snap["rejected"] \
                != len(handles):
            raise AssertionError(
                f"{phase}: {snap['completed']} completed + "
                f"{snap['dropped']} dropped + {snap['rejected']} rejected "
                f"!= {len(handles)} submitted")
        exports = self.export(client)
        pools = client.router.telemetry.pools
        report = ctrl.report()
        budget = (ctrl.initial_level_j
                  + self.ospec.profile().energy_between(0.0, client.now))
        emit("orbit", run=phase, card=self.card,
             transitions=report["transitions"],
             deferred=snap["energy_deferred"],
             energy_rejected=snap["energy_rejected"],
             scale_actions=report["scale_actions"], wall_s=wall,
             virtual_s=client.now,
             decode_tok_s={name: (c.decode_tokens / c.decode_s
                                  if c.decode_s else None)
                           for name, c in sorted(pools.items())},
             energy_ratio_cost_model_units=round(snap["energy_j"] / budget,
                                                 4))
        return exports

    def export(self, client) -> dict:
        """The four exports into a temporary directory: the Chrome trace
        parses, has one lane per pool that took work and holds every mode
        event; every Prometheus counter equals its snapshot field; the
        spans file has one line a span; the SLO report's telemetry is the
        snapshot."""
        import tempfile
        from repro_torch.obs import (export_chrome_trace, export_prometheus,
                                     export_slo_report, export_spans_jsonl)
        phase = self.phase
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            export_chrome_trace(client, tmp / "trace.json")
            n_spans = export_spans_jsonl(client, tmp / "spans.jsonl")
            text = export_prometheus(client, str(tmp / "metrics.prom"))
            report = export_slo_report(client, str(tmp / "slo.json"))
            snap = client.telemetry
            trace = json.loads((tmp / "trace.json").read_text())
            lines = (tmp / "spans.jsonl").read_text().splitlines()
            slo = json.loads((tmp / "slo.json").read_text())
        events = trace["traceEvents"]
        lanes = {e["args"]["name"] for e in events
                 if e["ph"] == "M" and e["name"] == "process_name"}
        busy = {name for name, c in snap["pools"].items() if c["dispatched"]}
        if lanes != {"fleet"} | busy:
            raise AssertionError(f"{phase}: trace lanes {sorted(lanes)} for "
                                 f"the pools that took work {sorted(busy)}")
        marks = sum(e["name"] == "mode" for e in events)
        if marks != len(self.ctrl.transitions):
            raise AssertionError(f"{phase}: {marks} mode events in the "
                                 f"trace for {len(self.ctrl.transitions)} "
                                 f"transitions")
        if n_spans != len(lines) or n_spans != len(client.tracer.spans):
            raise AssertionError(f"{phase}: {len(lines)} span lines for "
                                 f"{len(client.tracer.spans)} spans")
        if slo["telemetry"] != json.loads(json.dumps(report["telemetry"])) \
                or report["telemetry"] != snap:
            raise AssertionError(f"{phase}: the SLO report's telemetry is "
                                 f"not the snapshot")
        counters = 0
        for line in text.splitlines():
            name, _, value = line.rpartition(" ")
            if name.startswith("repro_fleet_events_total{event="):
                key = name.split('"')[1]
                want = snap[key]
            elif name.startswith("repro_pool_") and name.endswith("}"):
                field = name[len("repro_pool_"):name.index("_total{")]
                want = snap["pools"][name.split('"')[1]][field]
            else:
                continue
            if float(value) != want:
                raise AssertionError(f"{phase}: Prometheus {name} = {value}, "
                                     f"snapshot {want}")
            counters += 1
        if not counters:
            raise AssertionError(f"{phase}: no Prometheus counter")
        return {"trace_events": len(events), "trace_lanes": sorted(lanes),
                "spans_jsonl": n_spans, "prometheus_counters": counters}


def orbit_full_width_phase(dev, card: str, cfg, params, kernels,
                           batch_s: float) -> dict:
    """Qwen3-14B at full width through an eclipse: ``ORBIT_SPEC`` (the two
    engine pools and the cost-model pool of ``FLEET_SPEC``, and a priority-1
    class) under the port's orbit controller, sized to ``batch_s``, with
    the seeded greedy open loop of ``fleet_full_width_phase`` over
    ``ORBIT_MIX`` (``orbit_full_width``); then a short run of the same
    fleet with a full battery, the storm ladder on and ``FLEET_FAULTS``'
    ``kv_bitflip`` (``orbit_storm``).  Returns each run's launches by
    kernel, counted from 0."""
    runs = {}
    for phase, spec, storm, n_lm in (
            ("orbit_full_width", ORBIT_SPEC, False, ORBIT_LM),
            ("orbit_storm", {**ORBIT_SPEC, "faults": FLEET_FAULTS[:1]}, True,
             8)):
        runs[phase] = fleet_run(dev, card, cfg, params, kernels, spec, phase,
                                sampled=False, n_lm=n_lm, mix=ORBIT_MIX,
                                orbit=OrbitRun(phase, card, batch_s,
                                               storm=storm))[0]
    return runs


# sha256 (first 16 hex digits) of the reference's reports at the launchers'
# defaults, as ``json.dumps(report, sort_keys=True)``: the two eclipse
# scenarios, the dashboard's final report and its frames.  The runs are plain
# Python on the virtual clock; ``tests/test_torch_launch.py`` holds these
# digests to the reference's own runs.
VISION_ORBIT_DIGESTS = {"orbit_eclipse_on": "93f0de1ea556b868",
                        "orbit_eclipse_off": "250a51a247302549",
                        "top_report": "720b7e93e8725d46",
                        "top_frames": "f1e41db0ee317eac"}


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()[:16]


def vision_orbit_phase() -> None:
    """The orbit and dashboard launchers at the reference's defaults on the
    card's machine (cost-model pools, no model): the eclipse scenario with
    and without the controller and ``top.run_dashboard`` give the
    reference's reports exactly (``VISION_ORBIT_DIGESTS``), every handle
    resolves, and the controller keeps the fleet within the orbit budget
    that the uncontrolled fleet overdraws (cost-model units)."""
    from repro_torch.launch import orbit, top
    t0 = time.perf_counter()
    reports = {}
    for controlled in (True, False):
        r = orbit.run_eclipse_scenario(controlled=controlled)
        reports[r["scenario"]] = r
        if r["unresolved_handles"]:
            raise AssertionError(f"vision_orbit: {r['scenario']} left "
                                 f"{r['unresolved_handles']} handles")
    frames = []
    reports["top_report"] = top.run_dashboard(emit=frames.append)
    reports["top_frames"] = frames
    on, off = reports["orbit_eclipse_on"], reports["orbit_eclipse_off"]
    if on["energy_ratio"] > off["energy_ratio"]:
        raise AssertionError(f"vision_orbit: energy_ratio {on['energy_ratio']}"
                             f" with the controller, {off['energy_ratio']} "
                             f"without")
    got = {k: digest(v) for k, v in reports.items()}
    if got != VISION_ORBIT_DIGESTS:
        raise AssertionError(f"vision_orbit: reports differ from the "
                             f"reference's: {got}")
    emit("vision_orbit", wall_s=time.perf_counter() - t0,
         energy_ratio_cost_model_units={"controlled": on["energy_ratio"],
                                        "uncontrolled": off["energy_ratio"]},
         deferred=on["deferred"], t_end_s=on["t_end_s"],
         transitions=len(on["controller"]["transitions"]),
         scale_actions=len(on["controller"]["scale_actions"]),
         dashboard_frames=len(frames), reports_equal_reference=True)


LAUNCH_SERVE = ["--arch", "qwen3-14b", "--plan", "mpai", "--requests", "16"]
LAUNCH_SERVE_MAX_NEW = 8    # the launcher's default budget a request


def launch_serve_phase(card: str, kernels) -> dict:
    """``python -m repro_torch.launch.serve --arch qwen3-14b --plan mpai
    --requests 16 --trace PATH`` at full width from the port's seeded init,
    as ``main(argv)``: 16 requests served with all their budgets' tokens,
    the trace has the pool's lane, and paged attention, the int8 GEMM and
    flash attention all launch.  Returns their launches, counted from 0."""
    import tempfile
    from repro_torch.launch import serve
    pa, im, fa = kernels
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve_trace.json"
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                 # the main path's counts start here
        t0 = time.perf_counter()
        out = serve.main(LAUNCH_SERVE + ["--trace", str(path)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = launches_now(pa, im, fa)
        trace = json.loads(path.read_text())
    requests = int(LAUNCH_SERVE[LAUNCH_SERVE.index("--requests") + 1])
    pool = out["pool"]
    if out["served"] != requests or \
            out["tokens"] != [LAUNCH_SERVE_MAX_NEW] * requests or \
            pool["tokens_generated"] != LAUNCH_SERVE_MAX_NEW * requests:
        raise AssertionError(f"launch_serve: served {out['served']}, tokens "
                             f"{out['tokens']}, pool "
                             f"{pool['tokens_generated']}")
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    if "serve" not in lanes:
        raise AssertionError(f"launch_serve: trace lanes {sorted(lanes)}")
    idle = [k for k, v in n.items() if not v]
    if idle:
        raise AssertionError(f"launch_serve: no launch of {idle}")
    emit("launch_serve", card=card, argv=LAUNCH_SERVE, wall_s=wall,
         served=out["served"], tokens=pool["tokens_generated"],
         batches=pool["batches"], busy_s=pool["busy_s"],
         decode_tok_s=pool["decode_tokens_per_s"],
         trace_events=out["trace_events"], trace_lanes=sorted(lanes),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         **{f"{k}_launches": v for k, v in n.items()})
    return n


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
    greedy, greedy_ms = {}, {}
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
            out = greedy[name] = serve(eng, trace, Request)
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
        greedy_ms[name] = st["decode_s"] / steps * 1e3
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
    plans = {"mpai": mpai, "bf16": None}
    for run, by_kernel in qwen_sampled_hardened_phase(
            dev, card, cfg, params, plans, trace, greedy, greedy_ms,
            (pa, im, fa)).items():
        for name, n in by_kernel.items():
            launches[name][f"{cfg.name}/{run}"] = n
    by_kernel, batch_s = fleet_full_width_phase(dev, card, cfg, params, pa,
                                                im, fa)
    for name, n in by_kernel.items():
        launches[name][f"{cfg.name}/fleet"] = n
    for name, n in fleet_sampled_hardened_phase(dev, card, cfg, params, pa,
                                                im, fa).items():
        launches[name][f"{cfg.name}/fleet_sampled_hardened"] = n
    by_run, per_chunk = coproc_full_width_phase(
        dev, card, cfg, params, mpai, trace, greedy["bf16"], (pa, im, fa))
    for run, by_kernel in by_run.items():
        for name, n in by_kernel.items():
            launches[name][f"{cfg.name}/{run}"] = n
    for name, n in fleet_coproc_phase(dev, card, cfg, params, (pa, im, fa),
                                      per_chunk).items():
        launches[name][f"{cfg.name}/fleet_coproc"] = n
    for run, by_kernel in orbit_full_width_phase(
            dev, card, cfg, params, (pa, im, fa), batch_s).items():
        for name, n in by_kernel.items():
            launches[name][f"{cfg.name}/{run}"] = n
    for run, by_kernel in (
            ("staged", staged_full_width_phase(dev, card, cfg, params,
                                               (pa, im, fa))),
            ("fleet_staged", fleet_staged_phase(dev, card, cfg, params,
                                                (pa, im, fa)))):
        for name, n in by_kernel.items():
            launches[name][f"{cfg.name}/{run}"] = n
    return launches


# The stage-axis pool's shape: one slot a microbatch, each slot's tokens
# right-padded to max_len (the flash kernel's S)
STAGED_SERVE = dict(max_slots=4, prompt_len=16, max_len=32)
# one more request than slots: the fifth is admitted into a freed slot
STAGED_REQUESTS = 5
STAGED_MONO = 2             # requests held to the monolithic forward


def staged_check_launches(what: str, cfg, eng, n: dict) -> None:
    """A stage-axis step runs every attention layer of both stages once a
    slot (full-sequence recompute): flash attention ``num_layers *
    max_slots`` times a decode step; paged attention never (no KV), the
    int8 GEMM never (the backbone is fake-quantized in float)."""
    steps = eng.stats()["decode_steps"]
    want = cfg.num_layers * eng.max_slots * steps
    if n["flash_attention"] != want or not steps:
        raise AssertionError(f"{what}: {n['flash_attention']} flash "
                             f"launches for {steps} decode steps (want "
                             f"{want})")
    if n["int8_matmul"] or n["paged_attention"]:
        raise AssertionError(f"{what}: int8 {n['int8_matmul']}, paged "
                             f"{n['paged_attention']} launches")


def staged_full_width_phase(dev, card: str, cfg, params, kernels) -> dict:
    """Qwen3-14B at full width through ``StageAxisEngine``: the
    fake-quantized int8 backbone (20 layers) and the bf16 tail and head
    (20 layers) as two pipeline stages on the one card, each on its own
    stream.  The engine's stage parameters are views (it allocates under
    0.5 GB); ``STAGED_REQUESTS`` greedy requests (2-16 token prompts,
    ``max_new`` 1-12) after
    a warm-up return ``max_new`` in-vocab tokens; the two shortest streams
    of more than one token equal the greedy argmax of the port's
    monolithic ``forward`` under the engine's plan at ``[1, max_len]`` (or
    part at a near-tie); the launches are ``staged_check_launches``'.
    Then one ``pipeline_apply`` over the 4 microbatches of a step on two
    streams against the same stage functions one after the other on one
    stream: bit-equal, and each timed in device ms (CUDA events, median of
    2 in turns).  Returns the run's launches, counted from 0."""
    from repro_torch.core.pipeline import (lm_two_stage_fns, pipeline_apply,
                                           split_lm_params_for_stages)
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed
    from repro_torch.runtime.serve import Request
    from repro_torch.serving.stage_executor import StageAxisEngine

    pa, im, fa = kernels
    gc.collect()                      # the earlier phases' engines, in cycles
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    eng = StageAxisEngine(params, cfg, num_stages=2, device=dev,
                          **STAGED_SERVE)
    torch.cuda.synchronize()
    built_gb = (torch.cuda.memory_allocated(dev) - before) / 1e9
    if built_gb >= 0.5:
        raise AssertionError(f"staged: the engine allocated {built_gb} GB "
                             f"(its stage parameters must be views)")
    if eng.devices != [dev, dev]:
        raise AssertionError(f"staged: stages on {eng.devices}")
    rng = np.random.default_rng(5)
    trace = [(rid, rng.integers(0, cfg.vocab_size, int(rng.integers(2, 17))
                                ).astype(np.int32), int(rng.integers(1, 13)))
             for rid in range(STAGED_REQUESTS)]
    serve(eng, [(-1, np.array([1, 2, 3], np.int32), 2)], Request)
    eng.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                     # the main path's counts start here
    t0 = time.perf_counter()
    out = serve(eng, trace, Request)
    wall = time.perf_counter() - t0
    n = launches_now(pa, im, fa)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for rid, _, max_new in trace:
        if len(out[rid]) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in out[rid]):
            raise AssertionError(f"staged: request {rid} returned "
                                 f"{out[rid]} for max_new={max_new}")
    staged_check_launches("staged", cfg, eng, n)
    st = eng.stats()
    steps = st["decode_steps"]

    # the monolithic forward's greedy stream, token by token, for the
    # STAGED_MONO shortest streams of more than one token (a forward at
    # full width takes ~0.25 s)
    S = eng.max_len
    ties = 0
    mono = sorted((r for r in trace if r[2] > 1), key=lambda r: r[2])
    for rid, prompt, _ in mono[:STAGED_MONO]:
        seq = list(map(int, prompt))
        for t, tok in enumerate(out[rid]):
            toks = torch.zeros((1, S), dtype=torch.int32, device=dev)
            toks[0, :len(seq)] = torch.tensor(seq, dtype=torch.int32)
            row = T.forward(params, cfg, toks, plan=eng.plan).logits[
                0, len(seq) - 1].float()
            if int(torch.argmax(row)) != tok:
                top2 = torch.topk(row, 2).values.cpu()
                margin = float(top2[0] - top2[1])
                if margin > 2 ** -5 * abs(float(top2[0])):
                    raise AssertionError(
                        f"staged: request {rid} parts from the monolithic "
                        f"forward at token {t} with top-2 margin {margin}")
                ties += 1
                break
            seq.append(tok)

    # one step's pipeline on two streams vs the stages on one stream
    period = T.pattern_period(cfg)
    fns = lm_two_stage_fns(cfg, eng.plan)[:2]
    stage_params = split_lm_params_for_stages(params, cfg, eng.plan, period)
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (eng.max_slots, S)), dtype=torch.int32,
        device=dev)
    x = embed(params["embed"], toks, torch.bfloat16)[:, None]

    def piped():
        return pipeline_apply(eng.devices, fns, stage_params, x,
                              hidden_shape=(1, S, cfg.d_model),
                              out_shape=(1, S, cfg.vocab_size))

    def sequential():
        return torch.stack([fns[1](fns[0](x[m].to(torch.bfloat16),
                                          stage_params[0]), stage_params[1])
                            for m in range(x.shape[0])])
    a, b = piped(), sequential()      # also the warm-up of each
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("staged: the pipeline on two streams is not "
                             "bit-equal to its stages on one")
    del a, b
    times = {piped: [], sequential: []}
    for _ in range(2):                # in turns: piped, sequential
        for fn, ts in times.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    pipe_ms, seq_ms = (float(np.median(ts)) for ts in times.values())
    emit("staged_serve", config=cfg.name, card=card, stages=2,
         stage_devices=[str(d) for d in eng.devices],
         requests=len(trace), tokens=st["total_tokens"], decode_steps=steps,
         decode_tok_s=st["decode_tokens"] / st["decode_s"],
         mean_step_ms=st["decode_s"] / steps * 1e3, admit_s=st["admit_s"],
         wall_s=wall, mean_occupancy=st["mean_occupancy"], peak_gb=peak_gb,
         engine_alloc_gb=built_gb, mono_checked=STAGED_MONO,
         mono_near_ties=ties, flash_attention_launches=n["flash_attention"],
         int8_matmul_launches=n["int8_matmul"],
         paged_attention_launches=n["paged_attention"])
    emit("staged_overlap", config=cfg.name, card=card,
         microbatches=eng.max_slots, seq=S, pipeline_ms=pipe_ms,
         sequential_ms=seq_ms, ratio=seq_ms / pipe_ms, bit_equal=True)
    del eng
    return n


FLEET_STAGED = {
    "pools": [{"name": "qwen-staged", "profiles": ["tpu_v5e_int8"],
               "backend": "engine", "capacity": 1, "max_window": 4,
               "max_wait_s": 0.0, "max_slots": STAGED_SERVE["max_slots"],
               "prompt_len": STAGED_SERVE["prompt_len"], "max_new": 8,
               "pipeline_stages": 2}],
    "workload": "transformer",
}
FLEET_STAGED_REQUESTS = 4


def fleet_staged_phase(dev, card: str, cfg, params, kernels) -> dict:
    """The same weights through the facade: ``FLEET_STAGED`` (one
    ``pipeline_stages=2`` pool) built with ``FleetSpec.build`` on the
    card, 4 greedy requests submitted at once and drained.  Invariants
    only (ROADMAP, "Wall time on the virtual clock"): the pool is a
    ``StageAxisEngine``, every request completes with its ``max_new``
    in-vocab tokens, and the launches are ``staged_check_launches'``.
    Returns them, counted from 0 after the build (its warm-up aside)."""
    from repro_torch.serving import FleetSpec
    from repro_torch.serving.stage_executor import StageAxisEngine

    pa, im, fa = kernels
    client = FleetSpec.from_dict(FLEET_STAGED).build(model=(cfg, params),
                                                     device=dev)
    eng = client.engines["qwen-staged"]
    if not isinstance(eng, StageAxisEngine):
        raise AssertionError(f"fleet_staged: pool serves through "
                             f"{type(eng).__name__}")
    rng = np.random.default_rng(8)
    zero_counts()
    t0 = time.perf_counter()
    hs = []
    for _ in range(FLEET_STAGED_REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(2, 17))
                              ).astype(np.int32)
        max_new = int(rng.integers(1, 7))
        hs.append((client.submit(prompt, slo="offline", max_new=max_new),
                   max_new))
    client.drain()
    wall = time.perf_counter() - t0
    n = launches_now(pa, im, fa)
    for i, (h, max_new) in enumerate(hs):
        toks = [int(t) for t in h.result().tokens]
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"fleet_staged: request {i} returned "
                                 f"{toks} for max_new={max_new}")
    snap = client.telemetry
    if snap["completed"] != snap["admitted"] or \
            snap["admitted"] != FLEET_STAGED_REQUESTS:
        raise AssertionError(f"fleet_staged: admitted {snap['admitted']}, "
                             f"completed {snap['completed']}")
    staged_check_launches("fleet_staged", cfg, eng, n)
    st = eng.stats()
    emit("fleet_staged", config=cfg.name, card=card,
         requests=FLEET_STAGED_REQUESTS, tokens=st["total_tokens"],
         decode_steps=st["decode_steps"],
         decode_tok_s=st["decode_tokens"] / st["decode_s"], wall_s=wall,
         flash_attention_launches=n["flash_attention"],
         int8_matmul_launches=n["int8_matmul"],
         paged_attention_launches=n["paged_attention"])
    del client, eng
    return n


COMPRESSION_ELEMENTS = 64 * 2 ** 20


def compression_phase(dev, card: str) -> None:
    """``compressed_grad_mean`` over a one-rank NCCL group on a 64 M-element
    f32 leaf and a small one: the large leaf's mean is its own
    quantize-dequantize round trip bit for bit, the small leaf comes back
    unchanged; timed in ms (CUDA events around the call)."""
    import torch.distributed as dist

    from repro_torch.optim.compression import (CHUNK, _chunk_dequant,
                                               _chunk_quant,
                                               compressed_grad_mean)

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        g = torch.Generator(device=dev).manual_seed(11)
        grads = {"w": torch.randn(COMPRESSION_ELEMENTS, generator=g,
                                  device=dev),
                 "b": torch.randn(100, generator=g, device=dev)}
        got = compressed_grad_mean(grads)
        want = _chunk_dequant(*_chunk_quant(grads["w"]), grads["w"].shape)
        torch.cuda.synchronize()
        if not torch.equal(got["w"].view(torch.int32),
                           want.view(torch.int32)):
            raise AssertionError("compression: the one-rank mean is not the "
                                 "round trip")
        if not torch.equal(got["b"].view(torch.int32),
                           grads["b"].view(torch.int32)):
            raise AssertionError("compression: the small leaf changed")
        del got, want
        timer = Timer(dev)
        ms = timer.ms(lambda: compressed_grad_mean(grads), reps=5)
        del timer
        chunks = COMPRESSION_ELEMENTS // CHUNK
        emit("compression", card=card, world=1, backend="nccl",
             elements=COMPRESSION_ELEMENTS, ms=ms,
             wire_bytes=COMPRESSION_ELEMENTS + 4 * chunks,
             f32_bytes=4 * COMPRESSION_ELEMENTS, bit_equal=True)
    finally:
        dist.destroy_process_group()


COPROC_SLOTS = 4            # decode slots per shard of the split
COPROC_GEOM = {k: v for k, v in QWEN_SERVE.items() if k != "max_slots"}


def coproc_full_width_phase(dev, card: str, cfg, params, mpai, trace,
                            unified: dict, kernels) -> tuple:
    """Qwen3-14B at full width through the co-processing split: an "mpai"
    prefill engine (one slot) feeding two bf16 decode shards of
    ``COPROC_SLOTS`` slots over the trace of ``full_width_phase``, every
    handoff through the wire.  Checks: ``max_new`` in-vocab tokens a
    request, a handoff a request with imports on both shards, every
    kernel's launches as ``CoProcLog`` says; one shard of
    ``COPROC_SLOTS`` slots gives the same tokens bit for bit (bf16 decode
    rows depend on their own row alone at a fixed shape) with, in the same
    run, a corrupted wire frame and a lost handoff (two replays) and a
    hardened seam whose bit flip is detected and restored through it;
    one shard of 8 slots (another decode shape) and a split with a bf16
    prefill stage against the unified bf16 engine part only at near-ties
    of the picks' top two logits.  Prints each handoff of the main run
    (wire bytes, ``to_bytes``/``from_bytes`` ms, the ``handoff`` and
    ``import`` stages' host ms) and each run's prefill ``admit_s``, decode
    tok/s per shard and peak memory.  Returns each run's launches by
    kernel and the int8 GEMMs of one prefill chunk."""
    from repro_torch.runtime.serve import (ContinuousBatchingEngine,
                                           CoProcServer, Request)

    pa, im, fa = kernels

    def server(prefill_plan, shards, slots, harden=False):
        hk = dict(harden=True) if harden else {}
        pre = ContinuousBatchingEngine(params, cfg, plan=prefill_plan,
                                       max_slots=1, device=dev, **COPROC_GEOM,
                                       **hk)
        return CoProcServer(pre, [ContinuousBatchingEngine(
            params, cfg, plan=None, max_slots=slots, device=dev,
            **COPROC_GEOM, **hk) for _ in range(shards)])

    # first-use costs, and the int8 GEMMs of one "mpai" prefill chunk
    co = server(mpai, 2, COPROC_SLOTS)
    log = CoProcLog(co)
    zero_counts()
    serve(co, [(-1, np.array([1, 2, 3], np.int32), 2),
               (-2, np.arange(1, 41, dtype=np.int32), 2)], Request)
    chunks, im_n = log.count("prefill_chunk"), im.int8_matmul.launches
    if not chunks or im_n % chunks:
        raise AssertionError(f"coproc warm-up: {im_n} int8 launches for "
                             f"{chunks} prefill chunks")
    per_chunk = im_n // chunks
    del co, log
    launches, outs = {}, {}

    def run(key, prefill_plan, shards, slots, inject=(), faults=(),
            harden=False, top2=False):
        co = server(prefill_plan, shards, slots, harden)
        log = CoProcLog(co)
        store = capture_top2(co) if top2 else None
        for method in inject:
            getattr(co, method)()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()                 # the main path's counts start here
        t0 = time.perf_counter()
        with HandoffTimes() as times:
            out = outs[key] = serve(co, trace, Request, faults=faults)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = launches[key] = launches_now(pa, im, fa)
        log.check(f"coproc {key}", cfg.num_layers, n,
                  per_chunk if prefill_plan is not None else 0)
        for rid, _, max_new in trace:
            toks = out[rid]
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
                raise AssertionError(f"coproc {key}: request {rid} returned "
                                     f"{toks} for max_new={max_new}")
        st = co.stats()
        if st["handoffs"] != len(trace) or (
                shards > 1 and not all(st["imports_by_shard"].values())):
            raise AssertionError(f"coproc {key}: {st['handoffs']} handoffs, "
                                 f"imports {st['imports_by_shard']}")
        for i, eng in enumerate(co.decodes):
            alloc = eng.alloc
            if alloc.available + len(alloc.quarantined) != alloc.num_blocks:
                raise AssertionError(f"coproc {key}: shard {i} holds "
                                     f"{alloc.num_blocks - alloc.available}"
                                     f" blocks after the run")
        per_shard = [e.stats() for e in co.decodes]
        wire = times.rows
        if key == "coproc":
            handoff_ms, import_ms = log.ms("handoff"), log.ms("import")
            for row in wire:
                emit("coproc_handoff", run=key, card=card, rid=row["rid"],
                     wire_bytes=row["bytes"], wire_mb=row["bytes"] / 1e6,
                     to_bytes_ms=row["to_bytes_ms"],
                     from_bytes_ms=row.get("from_bytes_ms"),
                     handoff_stage_ms=handoff_ms.get(row["rid"]),
                     import_stage_ms=import_ms.get(row["rid"]))
        emit("coproc_full_width", run=key, card=card, requests=len(trace),
             shards=shards, slots=slots,
             prefill_plan="mpai" if prefill_plan is not None else "bf16",
             tokens=st["total_tokens"], decode_steps=st["decode_steps"],
             handoffs=st["handoffs"], handoffs_lost=st["handoffs_lost"],
             handoffs_replayed=st["handoffs_replayed"],
             imports_by_shard=st["imports_by_shard"],
             seam_deferrals_by_shard=st["seam_deferrals_by_shard"],
             deferrals=st["deferrals"], prefill_tokens=st["prefill_tokens"],
             prefill_admit_s=st["admit_s"],
             decode_tok_s_by_shard=[s["decode_tokens"] / s["decode_s"]
                                    if s["decode_s"] else None
                                    for s in per_shard],
             decode_tok_s_summed=sum(s["decode_tokens"] / s["decode_s"]
                                     for s in per_shard if s["decode_s"]),
             decode_tok_s_overall=st["decode_tokens"] / st["decode_s"],
             decode_s=st["decode_s"], wall_s=wall,
             wire_mb_mean=float(np.mean([r["bytes"] for r in wire])) / 1e6,
             to_bytes_ms_mean=float(np.mean([r["to_bytes_ms"]
                                             for r in wire])),
             from_bytes_ms_mean=float(np.mean([r["from_bytes_ms"]
                                               for r in wire])),
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             **{k: st[k] for k in HARDENING},
             **{f"{k}_launches": v for k, v in n.items()})
        del co, log
        return out, st, store

    def parted(a: dict, b: dict) -> list:
        return sorted(rid for rid in a if a[rid] != b[rid])

    base, _, _ = run("coproc", mpai, 2, COPROC_SLOTS)
    # one shard of the same shape, a corrupted frame and a lost handoff
    # (two replays) and a hardened seam restoring a detected bit flip, in
    # one run: each alone gives the two-shard run's tokens bit for bit,
    # and so must all three together
    key = "coproc-1shard-faulted-hardened"
    out, st, _ = run(key, mpai, 1, COPROC_SLOTS,
                     ("inject_handoff_corruption", "inject_handoff_loss"),
                     QWEN_BITFLIP, True)
    if out != base:
        raise AssertionError(f"coproc {key}: requests {parted(out, base)} "
                             f"part from the two-shard run")
    if st["handoffs_replayed"] != 2:
        raise AssertionError(f"coproc {key}: {st['handoffs_replayed']} "
                             f"handoffs replayed")
    if not (st["bitflips_detected"] and st["replays"]
            and st["blocks_quarantined"]):
        raise AssertionError(f"coproc {key}: {st}")
    summary = {}
    by_rid = {rid: (rid, p, n) for rid, p, n in trace}
    for key, prefill_plan, shards, slots, want in (
            ("coproc-1shard-8", mpai, 1, 8, base),
            ("coproc-bf16", None, 2, COPROC_SLOTS, unified)):
        out, _, store = run(key, prefill_plan, shards, slots, top2=True)
        ties = near_tie_divergences(
            f"coproc {key}", {"cuda": out, "cpu": want}, trace,
            lambda rid, t: store[(rid, t)])
        bad = parted(out, want)
        summary[key] = {
            "streams_equal": len(trace) - len(bad),
            "near_tie_divergences": ties,
            "parted_long": [r for r in bad
                            if len(by_rid[r][1]) > QWEN_SERVE["prompt_len"]],
            "parted_short": [r for r in bad
                             if len(by_rid[r][1]) <= QWEN_SERVE["prompt_len"]]}
    emit("coproc_compare", card=card, **summary)
    return launches, per_chunk


# the co-processing fleet: one split pool ("mpai" prefill stage, two bf16
# decode shards) beside the cost-model pool, with a lost handoff
FLEET_COPROC = {
    "pools": [{"name": "qwen-coproc", "profiles": ["tpu_v5e_bf16"],
               "backend": "engine", "plan": "bf16",
               "prefill_backend": "engine", "prefill_plan": "mpai",
               "decode_shards": 2, "capacity": 1, "max_window": 8,
               "max_wait_s": 0.5, "max_slots": COPROC_SLOTS,
               "prompt_len": QWEN_SERVE["prompt_len"],
               "block_size": QWEN_SERVE["block_size"], "max_prompt_len": 64,
               "max_new": 32},
              FLEET_SPEC["pools"][-1]],
    "workload": "transformer", "dt": 0.01, "trace": True,
    "slos": FLEET_SPEC["slos"],
    "faults": [{"pool": "qwen-coproc", "at_s": 0.05,
                "kind": "handoff_loss"}],
}


# the sampled half of the Qwen3 trace, (temperature, top_k, seed) by rid:
# rid 5 draws top_k=1, rid 9 admits by chunked prefill
QWEN_SAMPLED = {1: (1.0, 0, 42), 3: (0.7, 50, -1), 5: (1.0, 1, 7),
                7: (2.0, 0, 2**31 - 1), 9: (0.7, 8, -2**31), 11: (1.0, 50, 3)}
QWEN_SOLO, QWEN_TOP1 = 1, 5        # the solo-vs-packed and top_k=1 rids
QWEN_BITFLIP = ((3, "arm_bitflip", 3),)
QWEN_STALL = ((2, "stall_slot", 0), (40, "unstall_slot", 0))


def qwen_sampled_hardened_phase(dev, card: str, cfg, params, plans: dict,
                                trace, greedy: dict, greedy_ms: dict,
                                kernels) -> dict:
    """Qwen3-14B at full width through the engine (``QWEN_SERVE``, the
    trace of ``full_width_phase``) with half its requests sampled, under
    "mpai" and bf16: every request returns exactly ``max_new`` in-vocab
    tokens, and the ``top_k=1`` request equals its greedy run (both solo,
    so the batch is the same; they may part only where the greedy logits'
    top two are an exact tie, which ``top_k=1`` keeps both of).  Under
    bf16, where a row's logits and KV depend on that row alone: the greedy
    requests equal the greedy-only run, a sampled request equals its solo
    run, ``harden=True`` with no fault equals the unhardened run with every
    hardening counter 0, and in one run an armed bit flip is detected,
    quarantined and recovered and a stalled slot trips the watchdog and
    replays, to the unfaulted streams with the books exact.  Under
    "mpai" the sampled trace runs hardened with a bit flip, in one run:
    its counters, books and budgets are checked, and the greedy requests
    that part from the greedy-only run are counted (int8 activations are
    quantized per tensor across the batch: a replay's masked rows move the
    scale).  Returns each run's launches by kernel; every run's counts are
    held to its ``StageLog``."""
    from repro_torch.runtime.sampling import SamplingParams
    from repro_torch.runtime.serve import ContinuousBatchingEngine, Request

    pa, im, fa = kernels
    sampling = {rid: SamplingParams(t, k, seed)
                for rid, (t, k, seed) in QWEN_SAMPLED.items()}
    by_rid = {rid: (rid, p, n) for rid, p, n in trace}
    launches, step_ms = {}, {}

    def run(key, plan_name, reqs, samp, faults=(), top2=None, **extra):
        eng = ContinuousBatchingEngine(params, cfg, plan=plans[plan_name],
                                       device=dev, **QWEN_SERVE, **extra)
        log = StageLog(eng, reqs)
        if top2 is not None:          # solo: row 0 of each pick is its row
            real = eng._pick

            def pick(logits, *a, **k):
                top2.append(torch.topk(logits[0].float(), 2).values.cpu())
                return real(logits, *a, **k)
            eng._pick = pick
        torch.cuda.synchronize()
        zero_counts()
        out = serve(eng, reqs, Request, samp, faults)
        torch.cuda.synchronize()
        n = launches[key] = launches_now(pa, im, fa)
        log.check(f"qwen {key}", cfg.num_layers, n)
        if (n["int8_matmul"] > 0) != (plan_name == "mpai"):
            raise AssertionError(f"qwen {key}: {n['int8_matmul']} int8 "
                                 f"launches")
        for rid, _, max_new in reqs:
            toks = out[rid]
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
                raise AssertionError(f"qwen {key}: request {rid} returned "
                                     f"{toks} for max_new={max_new}")
        st = eng.stats()
        if st["decode_steps"]:
            step_ms[key] = st["decode_s"] / st["decode_steps"] * 1e3
        alloc = eng.alloc
        if alloc.available + len(alloc.quarantined) != alloc.num_blocks:
            raise AssertionError(f"qwen {key}: {alloc.available} free + "
                                 f"{len(alloc.quarantined)} quarantined != "
                                 f"{alloc.num_blocks} blocks")
        emit("qwen_sampled_hardened", run=key, card=card,
             requests=len(reqs), sampled=sum(r in samp for r, _, _ in reqs),
             tokens=st["total_tokens"], decode_steps=st["decode_steps"],
             replayed_decode_calls=log.expected()[0] - st["decode_steps"],
             admission_rounds=log.count("admit"),
             mean_step_ms=step_ms.get(key), admit_s=st["admit_s"],
             quarantined=len(alloc.quarantined),
             **{k: st[k] for k in HARDENING},
             **{f"{k}_launches": v for k, v in n.items()})
        del eng
        return out, st

    def parted(a: dict, b: dict) -> list:
        return sorted(rid for rid in a if a[rid] != b[rid])

    def top1_equals_greedy(plan_name) -> int:
        """Solo greedy and solo ``top_k=1`` runs of ``QWEN_TOP1``; returns
        1 where they part at an exact tie of the greedy top two."""
        req = [by_rid[QWEN_TOP1]]
        top2 = []
        want, _ = run(f"top1-greedy-solo-{plan_name}", plan_name, req, {},
                      top2=top2)
        got, _ = run(f"top1-solo-{plan_name}", plan_name, req,
                     {QWEN_TOP1: sampling[QWEN_TOP1]})
        a, b = got[QWEN_TOP1], want[QWEN_TOP1]
        if a == b:
            return 0
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        if float(top2[t][0]) != float(top2[t][1]):
            raise AssertionError(f"qwen {plan_name}: top_k=1 token {t} is "
                                 f"{a[t]}, greedy {b[t]}, top two "
                                 f"{top2[t].tolist()}")
        return 1

    summary = {}
    for plan_name in ("bf16", "mpai"):
        summary[f"top1_ties_{plan_name}"] = top1_equals_greedy(plan_name)
        if plan_name == "bf16":
            sampled, st = run("sampled-bf16", "bf16", trace, sampling)
            bad = parted({r: sampled[r] for r in greedy["bf16"]
                          if r not in sampling}, greedy["bf16"])
            if bad:
                raise AssertionError(f"qwen bf16: greedy requests {bad} "
                                     f"part from the greedy-only run")
            solo, _ = run("solo-bf16", "bf16", [by_rid[QWEN_SOLO]],
                          {QWEN_SOLO: sampling[QWEN_SOLO]})
            if solo[QWEN_SOLO] != sampled[QWEN_SOLO]:
                raise AssertionError("qwen bf16: a sampled request parts "
                                     "from its solo run")
            # the bit flip and the stalled slot in one run: each alone
            # recovers to the unfaulted streams, and so must both
            for key, faults in (
                    ("harden-bf16", ()),
                    ("harden-bitflip-stall-bf16", QWEN_BITFLIP + QWEN_STALL)):
                out, hst = run(key, "bf16", trace, sampling, faults,
                               harden=True)
                if out != sampled:
                    raise AssertionError(f"qwen {key}: requests "
                                         f"{parted(out, sampled)} part from "
                                         f"the unfaulted run")
                c = {k: hst[k] for k in HARDENING}
                if not faults and any(c.values()):
                    raise AssertionError(f"qwen {key}: counters {c}")
                if faults and not (c["bitflips_detected"]
                                   and c["blocks_quarantined"]
                                   and c["watchdog_trips"]):
                    raise AssertionError(f"qwen {key}: counters {c}")
        else:
            # the sampled "mpai" run is the hardened one with its bit flip:
            # every request returns its tokens there too (``run``); the
            # greedy requests that part from the greedy-only run are
            # counted (int8 activations are quantized across the batch)
            out, hst = run("sampled-harden-bitflip-mpai", "mpai", trace,
                           sampling, QWEN_BITFLIP, harden=True)
            if not (hst["bitflips_detected"] and hst["blocks_quarantined"]):
                raise AssertionError(f"qwen harden-bitflip-mpai: {hst}")
            summary["mpai_bitflip_parted_greedy"] = parted(
                {r: out[r] for r in greedy["mpai"] if r not in sampling},
                greedy["mpai"])
    emit("qwen_step_ms", card=card, mean_step_ms={
        **{f"greedy-{k}": v for k, v in greedy_ms.items()}, **step_ms},
        **summary)
    return launches


# ---------------------------------------------------------------------------
# UrsoNet pose: the paper's Table I workload (training and serving)
# ---------------------------------------------------------------------------
# The heads' int8 GEMMs at FULL, (K, N): fc, head_loc, head_ori
URSONET_HEAD_GEMMS = ((256, 256), (256, 3), (256, 4))
POSE_TINY_STEPS = 3


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` is ``value`` while entered (the port's call sites
    read module attributes at call time)."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


def capture_features(cnn, apply, feat=None):
    """``apply()`` (an ``ursonet_apply`` call) with ``cnn.pdot`` watched:
    its (loc, quat) and the pooled features that reach the first FC
    product, replaced by ``feat`` when given (the heads alone)."""
    seen = []
    real = cnn.pdot

    def pdot(x, w, policy):
        if not seen and feat is not None:
            x = feat
        seen.append(x)
        return real(x, w, policy)

    with patched(cnn, "pdot", pdot):
        loc, q = apply()
    return loc, q, seen[0]


def tiny_pose_phase(dev) -> None:
    """``tests/test_pose_qat.py``'s UrsoNet (48 x 64, widths (8, 16)) on
    CUDA against the port on the CPU: the same weights (the port's seed-0
    init, made on the CPU) and the same batch.  The forward under the four
    serve pairs and an all-f32 pair: features, the heads on the CPU's
    features, and the whole network where the heads keep float
    activations, within ``2**-6 |ref| + 2**-8`` (f32: 1e-5), as
    ``tests/test_torch_pose.py`` holds the port to the reference (cuDNN
    sums in another order, and an int8 head amplifies a flipped ulp).
    Then three ``train_step``s under "fp32", "mpai" and f32: losses within
    2e-2 relative (f32: 1e-4)."""
    from repro_torch import pose
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.precision import PrecisionPolicy as P
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import pose_batch
    from repro_torch.models import cnn
    from repro_torch.optim import adamw

    cfg = cnn.UrsoNetConfig(name="test", image_hw=(48, 64), widths=(8, 16),
                            blocks_per_stage=1, fc_dim=32)
    cpu = torch.device("cpu")
    weights = cnn.ursonet_init(torch.Generator().manual_seed(0), cfg, cpu)
    sides = (("cpu", cpu), ("card", dev))
    on = {"cpu": weights, "card": tree_map(lambda t: t.to(dev), weights)}
    images = pose_batch(8, 0, image_hw=cfg.image_hw, device=cpu)["images"]
    pairs = {name: pols[2:] for name, pols in pose.POLICIES.items()}
    pairs["f32"] = (P.fp32(), P.fp32())
    for name, (bp, hp) in pairs.items():
        rel, abs_ = (1e-5, 1e-5) if name == "f32" else (2 ** -6, 2 ** -8)
        out = {}
        with torch.no_grad():
            for side, where in sides:
                out[side] = [t.cpu() for t in capture_features(
                    cnn, lambda: cnn.ursonet_apply(
                        on[side], cfg, images.to(where), bp, hp))]
            heads = [t.cpu() for t in capture_features(
                cnn, lambda: cnn.ursonet_apply(on["card"], cfg,
                                               images.to(dev), bp, hp),
                out["cpu"][2].to(dev))[:2]]
        int8_head = hp.precision.is_quantized
        checks = {"feat": (out["card"][2], out["cpu"][2]),
                  "heads_loc": (heads[0], out["cpu"][0]),
                  "heads_quat": (heads[1], out["cpu"][1])}
        if not int8_head:
            checks.update(loc=(out["card"][0], out["cpu"][0]),
                          quat=(out["card"][1], out["cpu"][1]))
        errs = {}
        for what, (got, want) in checks.items():
            err, ok = within(got, want, rel, abs_)
            errs[what] = err
            if not ok:
                raise AssertionError(f"tiny_pose {name}: {what} max |err| "
                                     f"{err} beyond {rel} |ref| + {abs_}")
        emit("tiny_pose_forward", pair=name, int8_head=int8_head,
             max_abs_err=errs)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=200,
                     weight_decay=0.0, grad_clip=1.0)
    trains = {"fp32": pose.POLICIES["fp32"][:2],
              "mpai": pose.POLICIES["mpai"][:2], "f32": (P.fp32(), P.fp32())}
    for name, pols in trains.items():
        losses = {}
        for side, where in sides:
            p, opt, ls = on[side], adamw.init(on[side]), []
            for s in range(POSE_TINY_STEPS):
                b = pose_batch(8, s, image_hw=cfg.image_hw, device=cpu)
                p, opt, loss = pose.train_step(
                    p, opt, b["images"].to(where), b["loc"].to(where),
                    b["quat"].to(where), cfg, pols, tc)
                ls.append(float(loss))
            losses[side] = ls
        bound = 1e-4 if name == "f32" else 2e-2
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["card"], losses["cpu"]))
        if not rel <= bound:
            raise AssertionError(f"tiny_pose train {name}: losses "
                                 f"{losses} apart by {rel} (> {bound})")
        emit("tiny_pose_train", pair=name, losses=losses, max_rel_err=rel)


def ursonet_macs(cfg) -> dict:
    """Multiply-accumulates of one image through ``ursonet_apply``, read
    off the network's shapes (SAME convs: outputs ceil(size / stride);
    the shortcut projection runs at stride 1 before its subsampling)."""
    h, w = cfg.image_hw
    ceil = lambda a, b: -(-a // b)
    h, w = ceil(h, 2), ceil(w, 2)
    stem = h * w * 7 * 7 * 3 * cfg.widths[0]
    convs, cin = 0, cfg.widths[0]
    for si, width in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if bi == 0 and si > 0 else 1
            if cin != width:
                convs += h * w * cin * width              # proj, stride 1
            h, w = ceil(h, stride), ceil(w, stride)
            convs += h * w * 9 * cin * width + h * w * 9 * width * width
            cin = width
    heads = cin * cfg.fc_dim + cfg.fc_dim * 7
    return {"stem": stem, "convs": convs, "heads": heads,
            "forward": stem + convs + heads,
            # + the weight gradients of everything and the input gradients
            # of all but the stem (the images need none)
            "train": 3 * (stem + convs + heads) - stem}


def ursonet_full_width_phase(dev, card: str, timer, im) -> dict:
    """Table I on the card: ``run_condition`` for each of the four
    conditions at ``configs/ursonet.FULL`` (192 x 256, widths 32-256, 2
    blocks a stage, fc 256) with the reference's defaults but 50 steps
    (batch 16, 8 eval batches of 16; the reference trains 200).  Every
    loss finite, the last below the first; the int8 GEMM launched 3 times
    an eval batch exactly where the serve head is int8 (``int8_ptq``,
    ``int8_qat``), and those evaluations equal, bit for bit, the same
    evaluation with ``int8_matmul_plain`` in the kernel's place; the
    kernel equals its plain version at the heads' shapes (M 16 and 32,
    K 256, N 256, 3, 4).
    Returns the int8 GEMM's launches by condition."""
    from repro_torch import pose
    from repro_torch.configs.ursonet import FULL
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(5)
    for m in (16, 32):
        for k, n in URSONET_HEAD_GEMMS:
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                              dtype=torch.int8)
            if not torch.equal(im.int8_matmul(x, w),
                               im.int8_matmul_plain(x, w)):
                raise AssertionError(f"int8_matmul != plain at M={m} K={k} "
                                     f"N={n}")
            try:
                lib_ms = timer.ms(lambda: torch._int_mm(x, w))
            except RuntimeError:
                lib_ms = None         # cuBLAS refuses the shape
            bound = roofline.kernel_bound("int8_matmul", m=m, k=k, n=n)
            emit("kernel_int8_matmul", M=m, K=k, N=n, exact=True,
                 shapes="ursonet head",
                 ms=timer.ms(lambda: im.int8_matmul(x, w)),
                 device_ms=timer.device_ms(lambda: im.int8_matmul(x, w)),
                 plain_ms=timer.ms(lambda: im.int8_matmul_plain(x, w)),
                 library_ms=lib_ms, bound_ms=bound["bound_ms"],
                 bound_by=bound["bound_by"])

    cfg, batch, batches, steps = FULL, 16, 8, 50
    macs = ursonet_macs(cfg)
    step_bound = 2 * macs["train"] * batch / roofline.PEAK_BF16 * 1e3
    emit("ursonet_macs", config=cfg.name, per_image=macs,
         train_step_bound_ms=step_bound, bound_by="bf16 tensor-core "
         "operations", eval_batch_bound_ms=2 * macs["forward"] * batch
         / roofline.PEAK_BF16 * 1e3)
    launches, seen = {}, {}
    real_step, real_train = pose.train_step, pose.train_ursonet
    real_eval, real_apply = pose.eval_ursonet, pose.ursonet_apply

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        out = real_step(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        seen["steps"].append((time.perf_counter() - t0, start, end))
        return out

    def kept_train(*a, **kw):
        seen["params"], seen["hist"] = real_train(*a, **kw)
        return seen["params"], seen["hist"]

    def timed_eval(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eval(*a, **kw)
        torch.cuda.synchronize()
        seen["eval_s"] = time.perf_counter() - t0
        return out

    for name, (_, _, sb, sh) in pose.POLICIES.items():
        seen.clear()
        seen["steps"] = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()                 # the main path's counts start here
        t0 = time.perf_counter()
        with patched(pose, "train_step", timed_step), \
                patched(pose, "train_ursonet", kept_train), \
                patched(pose, "eval_ursonet", timed_eval):
            row = pose.run_condition(name, cfg, steps=steps, batch=batch,
                                     device=dev)
        wall = time.perf_counter() - t0
        n = launches[f"{cfg.name}/{name}"] = im.int8_matmul.launches
        hist = seen["hist"]
        losses = [loss for _, loss in hist]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and np.isfinite([row["loce"], row["orie"]]).all()):
            raise AssertionError(f"ursonet {name}: history {hist}, row {row}")
        int8_head = sh.precision.is_quantized
        if n != (3 * batches if int8_head else 0):
            raise AssertionError(f"ursonet {name}: {n} int8_matmul launches "
                                 f"for {batches} eval batches")
        if int8_head:                 # the same eval with the plain GEMM
            outs = {}
            for tag, fn in (("kernel", ops.int8_matmul),
                            ("plain", im.int8_matmul_plain)):
                rec = []

                def kept_apply(*a, **kw):
                    rec.append(real_apply(*a, **kw))
                    return rec[-1]
                with patched(ops, "int8_matmul", fn), \
                        patched(pose, "ursonet_apply", kept_apply):
                    metrics = real_eval(seen["params"], cfg, sb, sh,
                                        batch=batch, device=dev)
                outs[tag] = (metrics, rec)
            same = outs["kernel"][0] == outs["plain"][0] and all(
                torch.equal(a, b) for ka, kb in zip(outs["kernel"][1],
                                                    outs["plain"][1])
                for a, b in zip(ka, kb))
            if not same or outs["kernel"][0] != (row["loce"], row["orie"]):
                raise AssertionError(f"ursonet {name}: eval with the kernel "
                                     f"{outs['kernel'][0]} vs plain "
                                     f"{outs['plain'][0]} vs run "
                                     f"{(row['loce'], row['orie'])}")
        wall_ms = [s * 1e3 for s, _, _ in seen["steps"]]
        dev_ms = [a.elapsed_time(b) for _, a, b in seen["steps"]]
        emit("ursonet_condition", condition=name, config=cfg.name, card=card,
             loce=row["loce"], orie=row["orie"],
             final_train_loss=row["final_train_loss"],
             first_train_loss=losses[0], steps=len(wall_ms), batch=batch,
             train_step_ms_wall=float(np.median(wall_ms)),
             train_step_ms_device=float(np.median(dev_ms)),
             train_step_bound_ms=step_bound,
             eval_images_per_s=batches * batch / seen["eval_s"],
             eval_s=seen["eval_s"], wall_s=wall,
             int8_gemm_launches=n, eval_bit_equal_to_plain=int8_head or None,
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    return launches


# ---------------------------------------------------------------------------
# LM training: the flash-attention backward kernel, tiny and full-width
# StableLM-2 1.6B training, fault-tolerant restart, the train launcher
# ---------------------------------------------------------------------------
FLASH_BWD_SRC = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/models/attention.py:115"
# (B, S, KVp, gp, hd, dtype): Qwen3's layout at the admission round and a
# 2048-token prefill, StableLM-2's at S 4096 (B 1 and the training batch of
# 4, the main path's shape and the row's), a ragged S at hd 64 and gp 1, an
# hd 128 layout with gp 4 (Jamba's, LLaVA-NeXT's), all on the wgmma route;
# the tiny configs' hd 16 on the mma.sync route, a ragged S in f32; the
# example twins' training shapes (quickstart's hd 32 on mma.sync,
# train_100m's hd 64 on wgmma), OLMoE-1B-7B's on a rank of the two-rank run
# (hd 128 on wgmma), StableLM-2's on a rank of the per-block (2, 1) run (bf16
# on wgmma, and f32)
FLASH_BWD_CASES = ((8, 32, 8, 5, 128, "bfloat16"),
                   (1, 2048, 8, 5, 128, "bfloat16"),
                   (1, 4096, 32, 1, 64, "bfloat16"),
                   (4, 4096, 32, 1, 64, "bfloat16"),
                   (2, 300, 4, 1, 64, "bfloat16"),
                   (2, 256, 2, 4, 128, "bfloat16"),
                   (2, 37, 2, 2, 16, "bfloat16"),
                   (2, 37, 2, 3, 64, "float32"),
                   (8, 64, 4, 1, 32, "bfloat16"),
                   (8, 512, 5, 2, 64, "bfloat16"),
                   (*OLMOE_FLASH, "bfloat16"),
                   (*TP_FLASH[0], "bfloat16"), (*TP_FLASH[2], "bfloat16"),
                   (*LAYER_GATHER_FLASH, "bfloat16"),
                   (*LAYER_GATHER_FLASH, "float32"))
# per gradient: max |err| <= tol * max |ref| and ||err|| <= fro * ||ref||
# (bf16: P and dS enter their products as bf16)
FLASH_BWD_TOL = {"bfloat16": (2 ** -6, 2 ** -7), "float32": (2 ** -16, 2 ** -18)}
# the ``kernels`` line's row of each bf16 route of the backward, and the
# case whose numbers it carries: the main path's shape (one StableLM-2
# layer of the training step) for wgmma, the tiny configs' hd 16 for
# mma.sync
FLASH_BWD_ROWS = {"wgmma": ("flash_attention_bwd", (4, 4096, 1, 64)),
                  "mma_sync": ("flash_attention_bwd_mma_sync",
                               (2, 37, 2, 16))}


def flash_backward_phase(timer, fa, dev) -> list:
    """The backward kernel against its plain version (autograd of
    ``flash_attention_plain``) at ``FLASH_BWD_CASES``, on every route:
    ``dq``, ``dk`` and ``dv`` within ``FLASH_BWD_TOL``, two launches
    bit-equal, the forward's ``lse`` consistent (the autograd path gives
    the kernel's own gradients); ``ms`` around the wrapper and
    ``device_ms`` of one wrapper call replayed from a CUDA graph, beside one
    ``scaled_dot_product_attention`` backward at the same shapes (timed
    only here: the port never calls it), and the forward kernel beside
    SDPA's forward and its bound.  Returns the ``kernels`` line's rows of
    the two bf16 routes."""
    g = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, kvp, gp, hd, dtype in FLASH_BWD_CASES:
        dt = getattr(torch, dtype)
        route = fa.bwd_route(dt, hd)
        mk = lambda *shape: torch.randn(shape, generator=g,
                                        device=dev).to(dt)
        q, do = mk(b, s, kvp, gp, hd), mk(b, s, kvp, gp, hd)
        k, v = mk(b, s, kvp, hd), mk(b, s, kvp, hd)
        out, lse = fa._forward(q, k, v, True)
        before = fa.flash_attention_bwd.launches_by_route[route]
        grads = fa.flash_attention_bwd(do, q, k, v, out, lse)
        again = fa.flash_attention_bwd(do, q, k, v, out, lse)
        torch.cuda.synchronize()
        if fa.flash_attention_bwd.launches_by_route[route] != before + 2:
            raise AssertionError(f"flash_attention_bwd: the {route} route "
                                 f"did not launch at hd {hd} {dtype}")
        if not all(torch.equal(a, c) for a, c in zip(grads, again)):
            raise AssertionError(f"flash_attention_bwd: two launches differ "
                                 f"at B={b} S={s} hd={hd}")
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        fa.flash_attention(qq, kk, vv).backward(do)
        if not all(torch.equal(a, c) for a, c in
                   zip((qq.grad, kk.grad, vv.grad), grads)):
            raise AssertionError(f"flash_attention: the autograd path's "
                                 f"gradients are not the kernel's at S={s}")
        del qq, kk, vv
        plain = fa.flash_attention_bwd_plain(do, q, k, v)
        max_tol, fro_tol = FLASH_BWD_TOL[dtype]
        errs = {}
        for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
            err = (got.float() - want.float())
            errs[name] = err.abs().max().item()
            ok = (bool(torch.isfinite(got).all())
                  and errs[name] <= max_tol * want.float().abs().max().item()
                  and torch.linalg.norm(err).item()
                  <= fro_tol * torch.linalg.norm(want.float()).item())
            if not ok:
                raise AssertionError(f"flash_attention_bwd {name} disagrees "
                                     f"with its plain version at B={b} "
                                     f"S={s} gp={gp} hd={hd} {dtype}: max "
                                     f"|err| {errs[name]}")
        del plain, again
        # the library yardstick: SDPA's forward and backward on [B, H, S, hd]
        ql = q.reshape(b, s, kvp * gp, hd).transpose(1, 2).contiguous() \
            .requires_grad_(True)
        kl, vl = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (k, v))
        dol = do.reshape(b, s, kvp * gp, hd).transpose(1, 2).contiguous()
        try:
            lib_fwd_ms = timer.ms(lambda: sdpa(ql, kl, vl, is_causal=True,
                                               enable_gqa=True), reps=10)
            ol = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
            lib_ms = timer.ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), dol, retain_graph=True), reps=10)
        except (RuntimeError, TypeError) as e:
            lib_ms = lib_fwd_ms = None
            lib_note = str(e).splitlines()[0]
        else:
            lib_note = None
        del ql, kl, vl, dol
        size = 2 if dt == torch.bfloat16 else 4
        work = dict(b=b, s=s, kvp=kvp, gp=gp, hd=hd, itemsize=size)
        bound = roofline.kernel_bound("flash_attention_bwd", **work)
        fwd_bound = roofline.kernel_bound("flash_attention", **work)
        call = lambda: fa.flash_attention_bwd(do, q, k, v, out, lse)
        rows[(b, s, gp, hd, dtype)] = row = {
            "route": route,
            "ms": timer.ms(call, reps=10),
            "device_ms": timer.device_ms(call, reps=10),
            "plain_ms": timer.ms(lambda: fa.flash_attention_bwd_plain(
                do, q, k, v), reps=3),
            "library_ms": lib_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "forward_ms": timer.ms(lambda: fa._forward(q, k, v, False),
                                   reps=10),
            "forward_library_ms": lib_fwd_ms, "forward_bound_ms": fwd_bound["bound_ms"],
            "max_abs_err": max(errs.values())}
        emit("kernel_flash_backward", B=b, S=s, KVp=kvp, gp=gp, hd=hd,
             dtype=dtype, **row, errs=errs, bit_equal=True,
             library_note=lib_note,
             tolerance=f"per gradient max|err| <= {max_tol} max|ref|, "
                       f"||err|| <= {fro_tol} ||ref||",
             bound_peak=("bf16 tensor cores, 989 TFLOP/s, 2.5x the "
                         "forward's operations" if dt == torch.bfloat16
                         else "f32 CUDA cores, 67 TFLOP/s"))
        del q, k, v, do, out, lse, grads
        torch.cuda.empty_cache()
    out_rows = []
    for route, (name, (b, s, gp, hd)) in FLASH_BWD_ROWS.items():
        main = rows[(b, s, gp, hd, "bfloat16")]
        out_rows.append({
            "name": name, "route": "cuda", "design": route,
            "source": FLASH_BWD_SRC, "replaces": FLASH_BWD_REPLACES,
            "launches": 0, "max_abs_err": max(
                r["max_abs_err"] for r in rows.values()
                if r["route"] == route),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "replaces_note": "no TPU counterpart: the reference trains "
                             "through XLA's autodiff of full_attention",
            "shapes": (f"B={b} S={s} gp={gp} hd={hd}" + (
                "; one StableLM-2 1.6B layer of the training step, KVp=32"
                if route == "wgmma" else "; the tiny configs' head dim"))
            + "; bound on bf16 tensor cores at 2.5x the forward's "
              "operations"})
    return out_rows


class StepClock:
    """``on_step`` hook: the wall time of each training step, from the end
    of the previous one (or ``start()``) to a synchronize after it."""

    def __init__(self):
        self.times = []
        self.t0 = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def __call__(self, step, state, metrics) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.times.append(now - self.t0)
        self.t0 = now


def train_launches(fa) -> dict:
    """The forward's launches and each bf16 backward route's, by their
    rows in the ``kernels`` line."""
    by_route = fa.flash_attention_bwd.launches_by_route
    return {"flash_attention": fa.flash_attention.launches,
            **{name: by_route[route]
               for route, (name, _) in FLASH_BWD_ROWS.items()}}


def train_idle(fa, cfg, n: dict) -> list:
    """The kernels of a bf16 training run of ``cfg`` that did not launch:
    the forward and the backward route of its head dim."""
    hd = cfg.resolved_head_dim()
    row = FLASH_BWD_ROWS[fa.bwd_route(torch.bfloat16, hd)][0]
    return [k for k in ("flash_attention", row) if not n[k]]


TINY_TRAIN_STEPS = 4
TINY_TRAIN_SHAPE = (64, 4)       # seq, batch


def tiny_train_phase(dev, fa) -> None:
    """``tiny_dense`` trained ``TINY_TRAIN_STEPS`` bf16 steps by the
    ``Trainer`` on CUDA (the flash kernel and its backward) and on the CPU
    (the plain attention), from the same init (made on the CPU) and data:
    every loss within 2**-7 of the CPU's (the kernel sums in another
    order; a step's bf16 gradients agree within 2e-2 and an early Adam
    step is +-lr a weight), every grad norm within 5e-2."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.tiny import TINY
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.train_loop import Trainer, TrainState

    shape = ShapeConfig("tiny", *TINY_TRAIN_SHAPE, "train")
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=50)
    mesh = MeshConfig((1, 1), ("data", "model"))
    hist = {}
    state0 = Trainer(TINY, shape, mesh, tc, device="cpu").init_state()
    for where in (dev, torch.device("cpu")):
        tr = Trainer(TINY, shape, mesh, tc, device=where)
        state = TrainState(*tree_map(lambda t: t.to(where), tuple(state0)))
        zero_counts()
        _, hist[where.type] = tr.run(
            state, lambda s: lm_batch(TINY, shape, s, device=where),
            TINY_TRAIN_STEPS, log_every=1)
        if where.type == "cuda":
            n = train_launches(fa)
    idle = train_idle(fa, TINY, n)
    if idle:
        raise AssertionError(f"tiny_train: no launch of {idle}")
    for c, g in zip(hist["cpu"], hist["cuda"]):
        if abs(c["loss"] - g["loss"]) > 2 ** -7 * c["loss"] or \
                abs(c["grad_norm"] - g["grad_norm"]) > 5e-2 * c["grad_norm"]:
            raise AssertionError(f"tiny_train: step {c['step']} CUDA "
                                 f"{g} against CPU {c}")
    emit("tiny_train", steps=TINY_TRAIN_STEPS, shape=TINY_TRAIN_SHAPE,
         loss_cuda=[h["loss"] for h in hist["cuda"]],
         loss_cpu=[h["loss"] for h in hist["cpu"]],
         grad_norm_cuda=[h["grad_norm"] for h in hist["cuda"]],
         grad_norm_cpu=[h["grad_norm"] for h in hist["cpu"]],
         tolerance="loss 2**-7 relative, grad norm 5e-2 relative",
         **{f"{k}_launches": v for k, v in n.items()})


def train_plans(dev, card: str, cfg, shape, steps: int, phase: str,
                reduced: list, counts, check, keep=None,
                keep_params: bool = True) -> dict:
    """``cfg`` trained ``steps`` steps of ``shape`` under bf16 and under
    "mpai" (``qat.train_plan``: a fake-quantized backbone) by the
    ``Trainer`` from its seeded init: loss and grad norm finite, step ms
    (median, each step ending in a synchronize), tokens/s, peak memory and
    ``counts()`` (kernel launches by row name), counted from 0 for each
    plan's run; ``check(counts)`` lists what is wrong with them.  Frees
    each state, but for the bf16 run's history, step times, state bytes,
    peak memory and (with ``keep_params``) final parameters, which go into
    the dict ``keep`` when one is given.  Returns ``{plan: counts}``."""
    from repro_torch.configs.base import MeshConfig, TrainConfig
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.train_loop import Trainer

    mesh = MeshConfig((1, 1), ("data", "model"))
    out = {}
    for name, plan in (("bf16", None),
                       ("mpai", qat.train_plan(PartitionPlan.mpai(
                           cfg.num_layers)))):
        tc = TrainConfig(total_steps=steps)
        tr = Trainer(cfg, shape, mesh, tc, plan=plan, device=dev)
        t0 = time.perf_counter()
        handed = [tr.init_state()]    # not kept: each old state is freed
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        clock = StepClock()
        zero_counts()                 # the main path's counts start here
        clock.start()
        state, hist = tr.run(handed.pop(),
                             lambda s: lm_batch(cfg, shape, s, device=dev),
                             steps, log_every=1, on_step=clock)
        n = counts()
        bad = [h for h in hist if not (np.isfinite(h["loss"])
                                       and np.isfinite(h["grad_norm"]))]
        if bad or int(state.step) != steps:
            raise AssertionError(f"{phase} {name}: {hist}")
        wrong = check(n)
        if wrong:
            raise AssertionError(f"{phase} {name}: {wrong}")
        step_ms = float(np.median(clock.times)) * 1e3
        emit(phase, card=card, config=cfg.name, plan=name,
             shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
             reduced=reduced,
             params=sum(p.numel() for p in tree_leaves(state.params)),
             init_s=init_s, step_ms=step_ms,
             step_ms_each=[t * 1e3 for t in clock.times],
             tokens_per_s=shape.tokens / (step_ms / 1e3),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
             loss=[h["loss"] for h in hist],
             grad_norm=[h["grad_norm"] for h in hist],
             **{f"{k}_launches": v for k, v in n.items()})
        out[name] = n
        if keep is not None and name == "bf16":
            keep.update(history=hist, step_ms_each=list(clock.times),
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        state_bytes=sum(t.numel() * t.element_size() for t
                                        in tree_leaves(tuple(state))))
            if keep_params:
                keep["params"] = state.params
        del state, tr
        gc.collect()
        torch.cuda.empty_cache()
    return out


TRAIN_SHAPE = (4096, 4)          # train_4k's sequence, its batch 256 cut to 4
TRAIN_STEPS = 4
FT_LAYERS = 1                    # the restart check's depth (checkpoint I/O)
FT_FAULT_AT = 2
FT_STEPS = 3
FT_EVERY = FT_STEPS + 1          # no periodic save: the fault at step 2 (the
#                                  third) restores the runner's step-0
#                                  baseline and replays three steps; one
#                                  save of 5.5 GB (two, at every 2 steps,
#                                  took 19-25 s of the script)


def train_full_width_phase(dev, card: str, fa, keep=None) -> dict:
    """StableLM-2 1.6B at full width (24 layers, d 2048, vocab 100352,
    remat) trained ``TRAIN_STEPS`` steps of 4 x 4096 tokens under bf16 and
    under "mpai" (``qat.train_plan``: a fake-quantized backbone) by the
    ``Trainer`` from its seeded init: loss and grad norm finite, step ms
    (median, each step ending in a synchronize), tokens/s, peak memory and
    the flash kernels' launches, counted from 0 for each plan's run.  Then
    fault-tolerant restart at the same widths, ``FT_LAYERS`` deep (each
    checkpoint of the 24-layer state is 19.7 GB of host copy and disk): an
    uninterrupted run of ``FT_STEPS`` against a ``FaultTolerantRunner``
    with a ``FaultInjector`` at step ``FT_FAULT_AT`` and ``checkpoint_every
    =FT_EVERY`` (the restore reads the baseline save); history and final
    parameters bit-equal.  ``keep``
    receives the bf16 run's history, step times and final parameters
    (``train_plans``) for ``train_sharded``."""
    import shutil
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.stablelm_1_6b import FULL
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.fault import FaultInjector, FaultTolerantRunner
    from repro_torch.runtime.train_loop import Trainer

    shape = ShapeConfig("train_4k_cut", *TRAIN_SHAPE, "train")
    mesh = MeshConfig((1, 1), ("data", "model"))
    data = lambda cfg: (lambda s: lm_batch(cfg, shape, s, device=dev))
    out = train_plans(dev, card, FULL, shape, TRAIN_STEPS,
                      "train_full_width", ["global batch 256 -> 4 (one card)"],
                      lambda: train_launches(fa),
                      lambda n: [f"no launch of {k}"
                                 for k in train_idle(fa, FULL, n)], keep)

    # fault-tolerant restart at full width, FT_LAYERS deep
    cfg = FULL.with_(num_layers=FT_LAYERS)
    tc = TrainConfig(total_steps=FT_STEPS, checkpoint_every=FT_EVERY)
    ref_tr = Trainer(cfg, shape, mesh, tc, device=dev)
    ref_state, ref_hist = ref_tr.run(ref_tr.init_state(), data(cfg),
                                     FT_STEPS, log_every=1)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="ft_ckpt_", dir=ROOT / "build")
    try:
        tr = Trainer(cfg, shape, mesh, tc, device=dev)
        ckpt = CheckpointManager(ckpt_dir, keep=2)
        runner = FaultTolerantRunner(tr, ckpt, max_restarts=1)
        t0 = time.perf_counter()
        state, hist = runner.run(tr.init_state(), data(cfg), FT_STEPS,
                                 on_step=FaultInjector({FT_FAULT_AT}),
                                 log_every=1)
        ckpt.wait()
        ft_s = time.perf_counter() - t0
        saved = ckpt.steps()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(ref_state.params), tree_leaves(state.params)))
    if runner.restarts != 1 or hist != ref_hist or not same_params:
        raise AssertionError(f"train_fault_tolerant: restarts "
                             f"{runner.restarts}, history {hist} against "
                             f"{ref_hist}, params equal {same_params}")
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(tuple(state)))
    emit("train_fault_tolerant", card=card, config=cfg.name,
         layers=FT_LAYERS, reduced=["global batch 256 -> 4",
                                    f"layers 24 -> {FT_LAYERS}"],
         fault_at=FT_FAULT_AT, restarts=runner.restarts, steps=FT_STEPS,
         checkpoint_gb=nbytes / 1e9, checkpoints_kept=saved, wall_s=ft_s,
         history_bit_equal=True, params_bit_equal=True,
         loss=[h["loss"] for h in hist])
    del ref_state, state, tr, ref_tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_sharded_phase(dev, card: str, fa, one: dict) -> dict:
    """StableLM-2 1.6B at full width (``train_full_width``'s model, shape,
    seed and batches, ``fsdp=True``) trained ``TRAIN_STEPS`` bf16 steps by
    the mesh ``Trainer`` on ``MeshConfig((1, 1))`` in a one-rank NCCL
    group: its state laid out by ``param_specs``, each step gathering,
    reducing and updating through the sharded path.  A collective over one
    rank is an identity, so the history and the final parameters must be
    bit-equal to the one-device ``Trainer``'s (``one``, kept by
    ``train_full_width``).  Step ms of both paths, the flash kernels'
    launches and peak memory (the one-device run's kept parameters
    included).  Returns ``{"bf16": launches}``."""
    import torch.distributed as dist

    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.stablelm_1_6b import FULL
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.train_loop import Trainer

    shape = ShapeConfig("train_4k_cut", *TRAIN_SHAPE, "train")
    mesh_cfg = MeshConfig((1, 1), ("data", "model"))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        # a one-device mesh in a world of one rank: the mesh path
        tr = Trainer(FULL.with_(fsdp=True), shape, mesh_cfg,
                     TrainConfig(total_steps=TRAIN_STEPS), device=dev)
        if tr.mesh is None:
            raise AssertionError("train_sharded: the Trainer took the "
                                 "one-device path")
        handed = [tr.init_state()]    # not kept: each old state is freed
        torch.cuda.reset_peak_memory_stats()
        clock = StepClock()
        zero_counts()                 # the main path's counts start here
        clock.start()
        state, hist = tr.run(handed.pop(),
                             lambda s: lm_batch(FULL, shape, s, device=dev),
                             TRAIN_STEPS, log_every=1, on_step=clock)
        n = train_launches(fa)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        same_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(state.params), tree_leaves(one["params"])))
        if hist != one["history"] or not same_params:
            raise AssertionError(
                f"train_sharded: history {hist} against the one-device "
                f"{one['history']}, params bit-equal {same_params}")
        idle = train_idle(fa, FULL, n)
        if idle:
            raise AssertionError(f"train_sharded: no launch of {idle}")
        kept_gb = sum(t.numel() * t.element_size()
                      for t in tree_leaves(one["params"])) / 1e9
        emit("train_sharded", card=card, config=FULL.name, plan="bf16",
             mesh=list(mesh_cfg.shape), backend="nccl", world=1, fsdp=True,
             shape={"seq_len": shape.seq_len, "batch": shape.global_batch},
             reduced=["global batch 256 -> 4 (one card)"],
             step_ms=float(np.median(clock.times)) * 1e3,
             step_ms_each=[t * 1e3 for t in clock.times],
             one_device_step_ms=float(np.median(one["step_ms_each"])) * 1e3,
             one_device_step_ms_each=[t * 1e3 for t in one["step_ms_each"]],
             peak_gb=peak_gb, kept_one_device_params_gb=kept_gb,
             loss=[h["loss"] for h in hist],
             grad_norm=[h["grad_norm"] for h in hist],
             history_bit_equal=True, params_bit_equal=True,
             **{f"{k}_launches": v for k, v in n.items()})
        del state, tr, handed
    finally:
        dist.destroy_process_group()
    one.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": n}


SHARDED_LAYERS = 2               # the two-rank check's depth
SHARDED_STEPS = 2
SHARDED_ACCUM = 2                # microbatches a step: two ranks' logits
#                                  (4 x 4096 x 100352 in f32 each) and their
#                                  gradients do not fit one card at once
SHARDED_MESHES = ((2, 1), (1, 2))
SHARDED_TIMEOUT_S = 400
# (2, 1) against the one-rank run.  The two ranks' GEMMs see other row
# counts and their gradients are summed in another order, so bf16 rounding
# parts them; an early Adam step moves a weight by about ``lr`` whatever
# its gradient's size, so the parameters' bound alone (``sharded_
# tolerance``) would pass any gradient.  What a wrong gradient moves:
# - each leaf's gradient slice, before AdamW, against the same slice of the
#   one-rank gradient, ||got - want|| / ||want||: 1 for a zero gradient,
#   2 for a flipped one, ~1.4 for another slice's; rounding gives 2.35e-3
#   at step 1 and 1.20e-2 at step 2, where step 1's rounding has already
#   parted the parameters (the worst leaf's, on an H100);
# - the mean |param diff|: a wrong gradient turns most Adam steps, ~lr/2
#   = 1.5e-6 at step 1, and rounding turns a few (1.47e-9 and 1.04e-8
#   after steps 1 and 2 on an H100).
# (1, 2) computes head-parallel: its row-parallel products sum f32
# partials in another order and round to bf16 once, its GEMMs see other
# widths, so rounding parts it as it parts (2, 1), and the same bounds
# hold it.
SHARDED_GRAD_REL = 2e-2
SHARDED_MEAN_DIFF = 1e-7
# the "mpai" serving forward of the held weights on (1, 2) against one
# rank: the prompt's shape, and the logits' bound (4 bf16 ulps of the
# largest: the bf16 layer's row-parallel sums round in another order)
TP_FORWARD_SHAPE = (512, 2)      # seq, batch
TP_LOGITS_REL = 2 ** -5


def sharded_tolerance(tc, step: int) -> float:
    """A parameter's bound after ``step`` bf16 steps on two ranks against
    one: 2.2 x the learning rates of those steps, since an early Adam step
    moves a weight by up to ``lr`` whatever its gradient's size
    (``STEP_TOL`` of ``tests/test_torch_train.py``)."""
    from repro_torch.optim.adamw import cosine_lr
    return 2.2 * sum(float(cosine_lr(tc, torch.tensor(t)))
                     for t in range(1, step + 1))


@contextlib.contextmanager
def kept_grads(seen: list):
    """While inside, each ``adamw.apply_updates`` call appends the leaves
    of the gradient it was given (on a mesh, the rank's slices) to
    ``seen``."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.optim import adamw

    def apply(params, grads, *a, **kw):
        seen.append(tree_leaves(grads))
        return real(params, grads, *a, **kw)
    with patched(adamw, "apply_updates", apply) as real:
        yield


@contextlib.contextmanager
def timed_collectives(spent: list):
    """``torch.distributed.all_reduce``, ``all_gather`` and
    ``all_to_all_single`` timed while inside: each call's wall ms, between
    two synchronizes, appended to ``spent``."""
    import torch.distributed as dist
    originals = {name: getattr(dist, name) for name in
                 ("all_reduce", "all_gather", "all_to_all_single")}

    def timing(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return out
        return call
    for name, fn in originals.items():
        setattr(dist, name, timing(fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


OLMOE_LAYERS = 1                 # the two-rank MoE run's depth
OLMOE_SHAPE = (512, 2)           # seq, global batch: t * k is 8192, the
#                                  per-row path; a rank's 4096 alone would
#                                  take the flat one
OLMOE_STEPS = 2
# "mpai" is the slice's run; bf16 runs the same steps without the
# fake-quantized layer, so that the free steps (``olmoe_rank``) of the two
# tell how far int8 rounding carries a parting of the parameters
OLMOE_PLANS = ("mpai", "bf16")
# the two-rank meshes: (2, 1) splits the batch, (1, 2) the experts (and
# the heads, the vocab)
OLMOE_MESHES = ("2x1", "1x2")
# a held two-rank step starts from the one-rank run's state, so its loss
# and aux loss part only by rounding: the ranks' GEMMs see other row
# counts (the loss 8.5e-8 apart on an H100; per-rank activation scales
# moved ``tiny_dense``'s two-rank loss by 1.75e-4 on the CPU)
OLMOE_LOSS_REL = 1e-5
OLMOE_AUX_REL = 1e-6
# a token's experts may differ between the two-rank and the one-rank run
# only where its router's k-th and (k+1)-th probabilities lie within this
# of each other: the ranks' GEMMs see other row counts, so bf16 rounding
# parts the hidden states by an ulp, which moves a probability by ~1e-6
ROUTE_NEAR_TIE = 1e-4


@contextlib.contextmanager
def routes_of(routes):
    """While inside, ``moe.route``: with ``routes`` a list, each call's
    experts are appended to it; with ``routes`` experts recorded so, each
    call takes the next of them (and their probabilities) instead of its
    own top k; None changes nothing."""
    from repro_torch.models import moe
    if routes is None:
        yield
        return
    record, calls = not routes, iter(list(routes))

    def route(probs, k):
        if record:
            gate, ids = real(probs, k)
            routes.append(ids)
            return gate, ids
        ids = next(calls)
        return torch.gather(probs, -1, ids), ids
    with patched(moe, "route", route) as real:
        yield


@contextlib.contextmanager
def routed(calls: list):
    """While inside, each ``moe.moe_apply`` call appends its routing to
    ``calls``, on the host: whether it dispatched through a buffer per
    batch row, each row's dropped slots (its ``S * k`` less the slots its
    buffer row holds; none on the flat, dropless path), its aux loss, and
    each token's top-k experts (sorted) and router margin (the k-th less
    the (k+1)-th probability)."""
    from repro_torch.models import moe
    seen = {}

    def ffn(params, buf, *args):
        # the whole dispatch buffer (an expert-parallel rank runs its part)
        seen["per_row"] = buf.ndim == 4
        if buf.ndim == 4:
            seen["filled"] = buf.detach().ne(0).any(-1).sum(dim=(1, 2))
        return real_ffn(params, buf, *args)

    def apply(params, mc, x, *args, **kw):
        out, aux = real_apply(params, mc, x, *args, **kw)
        b, s, d = x.shape
        k = mc.top_k
        probs = torch.softmax(x.detach().reshape(-1, d).float()
                              @ params["router"].detach().float(), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1)
        calls.append({
            "per_row": seen["per_row"],
            "dropped": ((s * k - seen["filled"]).tolist() if seen["per_row"]
                        else [0] * b),
            "aux": float(aux.detach()),
            "ids": top.indices[:, :k].sort(-1).values.reshape(b, s, k).cpu(),
            "margin": (top.values[:, k - 1]
                       - top.values[:, k]).reshape(b, s).cpu()})
        return out, aux
    with patched(moe, "_experts", ffn) as real_ffn, \
            patched(moe, "moe_apply", apply) as real_apply:
        yield


def route_differences(rank: int, one: list, mesh: list) -> tuple:
    """Each MoE call of the two-rank run against the same call of the
    one-rank run, for this rank's rows of the global batch: ``(wrong,
    near_ties)``.  A row whose dropped slots differ is excused only where
    every token whose experts differ has a router margin under
    ``ROUTE_NEAR_TIE`` in the one-rank run."""
    wrong, ties = [], []
    if len(one) != len(mesh):
        return [f"{len(mesh)} MoE calls against {len(one)}"], ties
    for i, (a, m) in enumerate(zip(one, mesh)):
        if a["per_row"] != m["per_row"]:
            wrong.append(f"call {i}: per-row dispatch {m['per_row']} against "
                         f"{a['per_row']}")
            continue
        part = len(m["dropped"])
        for j in range(part):
            g = rank * part + j           # the row in the global batch
            if m["dropped"][j] == a["dropped"][g]:
                continue
            moved = (m["ids"][j] != a["ids"][g]).any(-1)
            margin = float(a["margin"][g][moved].max()) if moved.any() \
                else None
            at = {"call": i, "row": g, "dropped": m["dropped"][j],
                  "one_rank_dropped": a["dropped"][g],
                  "tokens_moved": int(moved.sum()), "max_margin": margin}
            if margin is not None and margin < ROUTE_NEAR_TIE:
                ties.append(at)
            else:
                wrong.append(f"routes part without a near-tie: {at}")
    return wrong, ties


def leaf_names(tree, at: str = "") -> list:
    """Each leaf's path in ``tree``, in ``tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{at}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{at}/{i}")]
    return [at.lstrip("/")]


def route_parting(rank: int, one: dict, mesh: dict) -> dict:
    """One MoE call of the two-rank run against the one-rank run's, over
    this rank's rows: the tokens whose top-k experts differ, the largest
    one-rank router margin among them, and the rows whose dropped slots
    differ."""
    part = len(mesh["dropped"])
    rows = slice(rank * part, (rank + 1) * part)
    moved = (mesh["ids"] != one["ids"][rows]).any(-1)
    return {"tokens_moved": int(moved.sum()), "of": moved.numel(),
            "max_margin": (float(one["margin"][rows][moved].max())
                           if moved.any() else None),
            "rows_dropped_differ": sum(
                a != b for a, b in zip(mesh["dropped"],
                                       one["dropped"][rows]))}


def parting_after_step(tr, st, start, names, lr: float) -> dict:
    """Where the two-rank run's parameters part from the one-rank run's
    after an Adam step, by leaf: the entries of the rank's slice that moved
    more than ``lr`` apart (a first Adam step moves a weight by about
    ``+-lr`` whatever its gradient's size, so an update whose sign flipped
    parts by ~2 lr, rounding by ~1e-9), and for each layer's weight that
    ``"mpai"`` fake-quantizes (every leaf of two or more dims a layer but
    the router) the int8 codes of its per-output-channel quantization that
    differ (the whole leaf, gathered; under bf16 the codes it would
    have)."""
    from repro_torch.core.quantization import quantize
    from repro_torch.core.tree import tree_leaves
    flipped, codes = {}, {}
    for n, a, b in zip(names, tree_leaves(st.params), tree_leaves(
            tr.param_shardings.shard(start.params))):
        moved = int(((a.float() - b.float()).abs() > lr).sum())
        if moved:
            flipped[n] = [moved, a.numel()]
    whole = tree_leaves(tr.param_shardings.unshard(st.params))
    for n, a, b in zip(names, whole, tree_leaves(start.params)):
        if n.startswith("layers/") and a.ndim >= 3 and \
                not n.endswith("/router"):
            differ = sum(int((quantize(x, channel_axis=-1).values
                              != quantize(y, channel_axis=-1).values).sum())
                         for x, y in zip(a, b))
            codes[n] = [differ, a.numel()]
    del whole
    return {"flipped": flipped, "codes": codes}


def olmoe_rank(rank: int, dev, plan_name: str) -> dict:
    """One rank of ``olmoe_sharded_2rank``: OLMoE-1B-7B at full width,
    ``OLMOE_LAYERS`` deep, ``OLMOE_STEPS`` steps of ``plan_name`` (one of
    ``OLMOE_PLANS``) of the global batch on (1, 1), then on (2, 1) and on
    (1, 2) (expert-parallel; the same weights, from ``tc.seed``),
    each step's gradient as AdamW gets it and its MoE routing recorded.
    On (2, 1), before each later step: where the parameters part from the
    one-rank run's (``parting_after_step``), that step run freely from the
    two-rank state (``free``), then again from the one-rank run's state
    (the held step).  On (1, 2) every later step is held so, and every
    step takes the one-rank run's experts (``routes_of``): the tokens its
    own router would move are reported and must lie at near-ties.
    Returns what the parent checks."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.olmoe_1b_7b import FULL
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim.adamw import cosine_lr
    from repro_torch.runtime.train_loop import Trainer

    cfg = FULL.with_(num_layers=OLMOE_LAYERS)
    shape = ShapeConfig("olmoe_2x512", *OLMOE_SHAPE, "train")
    tc = TrainConfig(total_steps=OLMOE_STEPS)
    plan = (qat.train_plan(PartitionPlan.mpai(OLMOE_LAYERS))
            if plan_name == "mpai" else None)
    runs, ref, starts, one_calls, one_routes = {}, [], [], [], []

    def record():
        return {"loss": [], "grad_norm": [], "aux": [], "step_ms": [],
                "collective_ms": [], "grad_rel_err": [], "calls": []}

    def step(tr, st, s, rec, routes=None):
        spent, seen, calls = [], [], []
        batch = lm_batch(cfg, shape, s, device=dev)
        torch.cuda.synchronize()
        held = step_peak_start(st)
        t0 = time.perf_counter()
        with timed_collectives(spent), kept_grads(seen), routed(calls), \
                routes_of(routes):
            st, m = tr.step_fn(st, batch)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        step_peak_end(rec, held)
        rec["collective_ms"].append(sum(spent))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["aux"].append([c["aux"] for c in calls])
        rec["calls"].append(calls)
        if tr.state_shardings is None:
            ref.append(seen[0])           # the whole gradient, on the card
            one_routes.append(routes)
        else:
            rec["grad_rel_err"].append(max(
                float(torch.linalg.vector_norm(g.float() - w[
                    tr.param_shardings.slices(sp, w.shape)].float())
                    / torch.linalg.vector_norm(w.float()))
                for g, w, sp in zip(seen[0], ref[s],
                                    tree_leaves(tr.param_specs))))
        return st

    for ms in ((1, 1), (2, 1), (1, 2)):
        tr = Trainer(cfg, shape, MeshConfig(ms, ("data", "model")), tc,
                     plan=plan, device=dev)
        st = tr.init_state()
        run = runs["x".join(map(str, ms))] = record()
        if ms != (1, 1):
            run.update(max_abs_diff=[], mean_abs_diff=[])
            torch.cuda.reset_peak_memory_stats()
            zero_counts()             # this rank's main path starts here
        if ms == (2, 1):
            names = leaf_names(st.params)
            run.update(parting=[])
            free = run["free"] = dict(record(), routes=[])
        for s in range(OLMOE_STEPS):
            if ms == (1, 2) and s:
                # held: from the one-rank run's state, after noting where
                # the parameters stand from it
                held_diffs(tr, st, starts[s - 1], run)
                for dst, src in zip(tree_leaves(st), tree_leaves(
                        tr.state_shardings.shard(starts[s - 1]))):
                    dst.copy_(src)
            if ms == (1, 2):
                # the one-rank run's experts: its hidden states part from
                # these by bf16 rounding (the row-parallel sums), which
                # moves tokens at near-ties; held to the same routes, the
                # expert-parallel step is compared as (2, 1)'s is, and
                # the routes its own router picks are checked apart
                st = step(tr, st, s, run, one_routes[s])
                continue
            if ms == (2, 1) and s:
                # the parameters after step s against the one-rank run's
                # (``parting_after_step`` says where an update's sign
                # flipped and which int8 codes moved), step s + 1 run
                # freely, then again from the one-rank run's state, so
                # that each held step starts where the one-rank one did
                held_diffs(tr, st, starts[s - 1], run)
                run["parting"].append(parting_after_step(
                    tr, st, starts[s - 1], names,
                    float(cosine_lr(tc, torch.tensor(s)))))
                st = step(tr, st, s, free)
                free["routes"].append([
                    route_parting(rank, a, m)
                    for a, m in zip(one_calls[s], free["calls"][-1])])
                for dst, src in zip(tree_leaves(st), tree_leaves(
                        tr.state_shardings.shard(starts[s - 1]))):
                    dst.copy_(src)
            st = step(tr, st, s, run, [] if ms == (1, 1) else None)
            if ms == (1, 1) and s + 1 < OLMOE_STEPS:
                starts.append(tree_map(torch.clone, st))
        if ms == (1, 1):
            one_calls = run["calls"]
        else:
            run["launches"] = train_launches(fa)
        del st, tr
        gc.collect()
        torch.cuda.empty_cache()
    del ref, starts
    flat = lambda calls: [c for step_calls in calls for c in step_calls]
    one = flat(runs["1x1"].pop("calls"))
    wrong, ties = {}, {}
    for name in OLMOE_MESHES:
        mesh = runs[name]
        if name == "2x1":             # the rank's rows
            wrong[name], ties[name] = route_differences(
                rank, one, flat(mesh["calls"]))
        else:                         # every row, its own router's picks
            wrong[name], ties[name] = [], []
            for i, (a, m) in enumerate(zip(one, flat(mesh["calls"]))):
                p = route_parting(0, a, m)
                if p["max_margin"] is None:
                    continue
                (ties if p["max_margin"] < ROUTE_NEAR_TIE
                 else wrong)[name].append(dict(p, call=i))
        calls = flat(mesh.pop("calls"))
        mesh["per_row"] = [c["per_row"] for c in calls]
        mesh["dropped"] = [c["dropped"] for c in calls]
    free = runs["2x1"]["free"]
    free["per_row"] = [c["per_row"] for c in flat(free.pop("calls"))]
    return {"runs": runs, "route_wrong": wrong, "near_ties": ties}


def held_diffs(tr, st, start, run: dict) -> None:
    """The max and mean |diff| of the rank's parameters from the same
    parts of the one-rank run's ``start``, appended to ``run``."""
    from repro_torch.core.tree import tree_leaves
    diffs = [(a.float() - b.float()).abs() for a, b in zip(
        tree_leaves(st.params),
        tree_leaves(tr.param_shardings.shard(start.params)))]
    run["max_abs_diff"].append(max(float(x.max()) for x in diffs))
    run["mean_abs_diff"].append(sum(float(x.sum()) for x in diffs)
                                / sum(x.numel() for x in diffs))


def train_rank(rank: int, world: int, d: str) -> None:
    """One rank of ``train_sharded_2rank`` (run as ``python3 chip_smoke.py
    train-rank RANK WORLD DIR``): joins the gloo group through a
    ``FileStore`` in ``DIR``, trains, checks, and writes its results to
    ``DIR/rank<RANK>.json``."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.stablelm_1_6b import FULL
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.specs import param_structs
    from repro_torch.runtime.train_loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # what a process pays once, before the wait: its CUDA context, cuBLAS,
    # the flash libraries and the meta structs' imports
    x = torch.ones(64, 64, device=dev)
    float((x @ x).sum() + (x.bfloat16() @ x.bfloat16()).float().sum())
    for name in ("flash_attention", "flash_attention_bwd", "wkv", "wkv_bwd",
                 "selective_scan", "selective_scan_bwd"):
        build.load(name)
    param_structs(FULL.with_(num_layers=SHARDED_LAYERS), 1)
    go = Path(d) / "go"
    waited = time.perf_counter()
    while not go.exists():            # the parent's card is busy till then
        if time.perf_counter() - waited > SHARDED_TIMEOUT_S * 3:
            raise TimeoutError(f"train-rank {rank}: no {go}")
        time.sleep(0.1)
    began = time.perf_counter()
    marks = {}                        # seconds from the go, by stage

    def mark(stage: str) -> None:
        marks[stage] = time.perf_counter() - began
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(d) / "store"), world),
        rank=rank, world_size=world)
    mark("joined")
    try:
        cfg = FULL.with_(num_layers=SHARDED_LAYERS, fsdp=True,
                         grad_accum=SHARDED_ACCUM)
        shape = ShapeConfig("train_4k_cut", *TRAIN_SHAPE, "train")
        tc = TrainConfig(total_steps=SHARDED_STEPS)
        data = lambda s: lm_batch(cfg, shape, s, device=dev)
        one_mesh = MeshConfig((1, 1), ("data", "model"))
        res = {"rank": rank, "meshes": {}}
        # the one-rank run, on each rank at once (each holds the parts it
        # checks against it, and so no gather is needed to check them)
        ref = []
        one = Trainer(cfg, shape, one_mesh, tc, device=dev)
        st = one.init_state()
        for s in range(SHARDED_STEPS):
            seen = []
            with kept_grads(seen):
                st, m = one.step_fn(st, data(s))
            # the whole gradient waits on the host (2 GB a step)
            ref.append(([p.clone() for p in tree_leaves(st.params)],
                        float(m["loss"]), float(m["grad_norm"]),
                        [g.to("cpu") for g in seen[0]]))
            del seen
        del st, one
        torch.cuda.empty_cache()
        res["one_rank"] = {"loss": [r[1] for r in ref],
                           "grad_norm": [r[2] for r in ref]}
        mark("one_rank_run")
        dist.barrier()
        mark("barrier")
        ck = CheckpointManager(str(Path(d) / "ckpt"), keep=1)
        for ms in SHARDED_MESHES:
            tr = Trainer(cfg, shape, MeshConfig(ms, ("data", "model")), tc,
                         device=dev)
            st = tr.init_state()
            mark(f"{ms} init")
            torch.cuda.reset_peak_memory_stats()
            zero_counts()             # this rank's main path starts here
            out = {"step_ms": [], "collective_ms": [], "loss": [],
                   "grad_norm": [], "max_abs_diff": [], "mean_abs_diff": [],
                   "bound": [], "grad_rel_err": [], "grad_equal": []}
            specs = tree_leaves(tr.param_specs)
            out["step_peak_bytes"] = out["step_only_peak_bytes"] = 0
            for s in range(SHARDED_STEPS):
                spent, seen = [], []
                torch.cuda.synchronize()
                held = step_peak_start(st)
                t0 = time.perf_counter()
                with timed_collectives(spent), kept_grads(seen):
                    st, m = tr.step_fn(st, data(s))
                torch.cuda.synchronize()
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
                step_peak_end(out, held)
                out["collective_ms"].append(sum(spent))
                out["loss"].append(float(m["loss"]))
                out["grad_norm"].append(float(m["grad_norm"]))
                # this rank's slice of every gradient, as AdamW got it,
                # against the same slice of the one-rank gradient
                rel, equal = [], True
                for g, w, sp in zip(seen[0], ref[s][3], specs):
                    w = w[tr.param_shardings.slices(sp, w.shape)].to(dev)
                    equal = equal and torch.equal(g, w)
                    rel.append(float(torch.linalg.vector_norm(
                        g.float() - w.float())
                        / torch.linalg.vector_norm(w.float())))
                out["grad_rel_err"].append(max(rel))
                out["grad_equal"].append(equal)
                del seen, g, w
                # this rank's part of every parameter against the same
                # slice of the one-rank run's (the ranks' parts together
                # are the gathered parameters)
                diffs = [(a.float() - b[tr.param_shardings.slices(
                    sp, b.shape)].float()).abs() for a, b, sp in zip(
                        tree_leaves(st.params), ref[s][0], specs)]
                out["max_abs_diff"].append(max(float(x.max())
                                               for x in diffs))
                out["mean_abs_diff"].append(
                    sum(float(x.sum()) for x in diffs)
                    / sum(x.numel() for x in diffs))
                out["bound"].append(sharded_tolerance(tc, s + 1))
                del diffs
            if ms == (2, 1):
                saved = tree_map(torch.clone,
                                 tr.param_shardings.unshard(st.params))
            mark(f"{ms} steps")
            out["launches"] = train_launches(fa)
            if ms == (2, 1):          # written while (1, 2) trains
                t0 = time.perf_counter()
                ck.save(SHARDED_STEPS, st, shardings=tr.state_shardings)
                out["save_snapshot_s"] = time.perf_counter() - t0
            res["meshes"]["x".join(map(str, ms))] = out
            del st, tr
            gc.collect()
            torch.cuda.empty_cache()
            mark(f"{ms} freed")
        # the (2, 1) checkpoint restored on (1, 2) by both ranks, and on
        # (1, 1) by rank 0: bit-equal, then a step runs
        del ref
        restores = {}
        for ms in ((1, 2), (1, 1)):
            if ms == (1, 1) and rank != 0:
                continue
            t0 = time.perf_counter()
            if ms == (1, 1):
                tr = Trainer(cfg, shape, one_mesh, tc, device=dev)
                st, step = ck.restore(tr.state_like(), device=dev)
                parts = tree_leaves(saved)
            else:
                tr = Trainer(cfg, shape, MeshConfig(ms, ("data", "model")),
                             tc, device=dev)
                st, step = ck.restore(tr.state_like(), device=dev,
                                      shardings=tr.state_shardings)
                parts = tree_leaves(tr.param_shardings.shard(saved))
            restore_s = time.perf_counter() - t0
            equal = all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(st.params), parts))
            del parts
            st, m = tr.step_fn(st, data(SHARDED_STEPS))
            restores["x".join(map(str, ms))] = {
                "step": step, "bit_equal": equal, "restore_s": restore_s,
                "next_loss": float(m["loss"])}
            del st, tr
            gc.collect()
            torch.cuda.empty_cache()
            mark(f"restore {ms}")
        res["restores"] = restores
        res["tp_forward"] = tp_forward(rank, dev, cfg, shape, tc, saved)
        del saved
        mark("tp_forward")
        res["olmoe"] = {p: olmoe_rank(rank, dev, p) for p in OLMOE_PLANS}
        mark("olmoe")
        res["recurrent"] = {}
        for key in RECURRENT_RUNS:
            res["recurrent"][key] = {p: recurrent_rank(rank, dev, key, p)
                                     for p in RECURRENT_PLANS}
            mark(key)
        res["layer_gather"] = {p: layer_gather_rank(rank, dev, p)
                               for p in LAYER_GATHER_PLANS}
        mark("layer_gather")
        dist.barrier()
        mark("end")
        res["stage_s"] = marks
        (Path(d) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def step_peak_start(state) -> int:
    """Before a timed step: the peak counter reset, and the bytes the
    process holds beside ``state`` (what the dry run does not see)."""
    from repro_torch.core.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in tree_leaves(state)
        if torch.is_tensor(t))


def step_peak_end(out: dict, held: int) -> None:
    """After that step: ``step_peak_bytes``, the largest peak of a step so
    far, and ``step_only_peak_bytes``, that peak less what the process held
    beside the state (what the dry run predicts)."""
    peak = torch.cuda.max_memory_allocated()
    out["step_peak_bytes"] = max(out.get("step_peak_bytes", 0), peak)
    out["step_only_peak_bytes"] = max(out.get("step_only_peak_bytes", 0),
                                      peak - held)


def tp_forward(rank: int, dev, cfg, shape, tc, whole) -> dict:
    """One forward of ``whole`` (the parameters the (2, 1) run holds)
    under the ``"mpai"`` serving plan at ``TP_FORWARD_SHAPE``: on one rank,
    then head-parallel on (1, 2) with the rank's parts.  Layer 0 (int8)
    must come out bit-equal, the logits within ``TP_LOGITS_REL`` of the
    largest and their argmax equal but at a near-tie of the one-rank top
    two (``near_tie_divergences``' rule).  Returns what it measured."""
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig, ShapeConfig
    from repro_torch.core import collectives, qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.models import transformer as T
    from repro_torch.runtime.train_loop import Trainer
    seq, batch = TP_FORWARD_SHAPE
    tokens = lm_batch(cfg, ShapeConfig("tp_forward", seq, batch, "train"), 0,
                      device=dev)["tokens"]
    plan = qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
    tr = Trainer(cfg, shape, MeshConfig((1, 2), ("data", "model")), tc,
                 device=dev)
    local = tr.param_shardings.shard(whole)

    def forward(params, group):
        layers = []

        def keep(*a, **kw):
            x, new, aux = real(*a, **kw)
            layers.append(x)
            return x, new, aux
        with torch.no_grad(), patched(T, "_sublayer_apply", keep) as real, \
                collectives.model_group(group, 2 if group else 1, rank):
            logits = T.forward(params, cfg, tokens, plan, tr.tp).logits
        return logits, layers

    one, one_layers = forward(whole, None)
    zero_counts()
    mine, layers = forward(local, tr.placement.group(("model",)))
    torch.cuda.synchronize()
    launches = launch_counts()
    int8 = im.int8_matmul.launches
    parts = [torch.empty_like(mine) for _ in range(2)]
    dist.all_gather(parts, mine.contiguous())
    got = torch.cat(parts, dim=-1).float()
    want = one.float()
    err = float((got - want).abs().max()) / float(want.abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    moved = got.argmax(-1) != want.argmax(-1)
    margins = (top2[..., 0] - top2[..., 1])[moved]
    ties_ok = bool((margins <= 2 ** -5 * top2[..., 0][moved].abs()).all())
    res = {"layer0_bit_equal": bool(torch.equal(layers[0], one_layers[0])),
           "layers_bit_equal": [bool(torch.equal(a, b))
                                for a, b in zip(layers, one_layers)],
           "logits_rel_err": err, "argmax_moved": int(moved.sum()),
           "argmax_of": moved.numel(), "near_ties_only": ties_ok,
           "int8_launches": int8, "launches": launches, "seq_len": seq,
           "batch": batch}
    del one, mine, parts, got, want, local, tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


def start_train_ranks(world: int = 2):
    """The ranks of ``train_sharded_2rank``, started early so that their
    imports and CUDA contexts overlap the phases before it: each waits for
    a ``go`` file in its directory under ``build/``.  Returns ``(procs,
    dir)``; ``stop_train_ranks`` ends them."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="sharded_", dir=ROOT / "build"))
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = []
    for rank in range(world):
        with open(d / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "train-rank",
                 str(rank), str(world), str(d)], stdout=log,
                stderr=subprocess.STDOUT, env=env))
    return procs, d


def stop_train_ranks(procs, d: Path) -> None:
    import shutil
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    shutil.rmtree(d, ignore_errors=True)


def train_sharded_2rank_phase(card: str, procs, d: Path) -> dict:
    """StableLM-2 1.6B at full widths, ``SHARDED_LAYERS`` deep
    (``fsdp=True``, ``grad_accum=SHARDED_ACCUM`` in every run, the
    one-rank one included), trained ``SHARDED_STEPS`` bf16 steps on two
    gloo ranks sharing the card (NCCL refuses two ranks on one device),
    the subprocesses of ``start_train_ranks`` joined through a
    ``FileStore``: on (2, 1) (data parallel, the state split over the data
    axis) and (1, 2) (the state split over the model axis, compute
    head-parallel).  After each step, against the one-rank run on the
    card: each rank's gradient slices within ``SHARDED_GRAD_REL`` (a
    leaf's relative L2 error), its parameters' mean |diff| within
    ``SHARDED_MEAN_DIFF`` and their max within ``sharded_tolerance``, the
    loss within 2**-7 and the grad norm within 5e-2 relative; each (1, 2)
    rank's step peak below its (2, 1) one.  The flash kernels launch on
    each rank; the (2, 1) checkpoint restores on (1, 1) and (1, 2)
    bit-equal and a step runs, and its parameters go through the "mpai"
    serving forward on (1, 2) against one rank (``tp_forward``).  Then
    the same ranks train OLMoE-1B-7B under each of ``OLMOE_PLANS``
    (``olmoe_rank``, ``olmoe_sharded_check``), RWKV-6's and Jamba's Mamba
    layers head-parallel (``recurrent_rank``), and StableLM-2 four layers
    deep on (2, 1), its stacked layers gathered one super-block at a time
    (``layer_gather_rank``, ``layer_gather_check``).  Gloo stages CUDA tensors
    through host memory, so the collective ms printed are a correctness
    run's, not a speed.  Returns ``({run: launches}`` of rank 0, ``{run:
    [step-only peak bytes a rank]})`` for the dry run's check."""
    t0 = time.perf_counter()
    (d / "go").touch()
    for p in procs:
        try:
            p.wait(timeout=max(1.0, SHARDED_TIMEOUT_S
                               - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            pass
    wall = time.perf_counter() - t0
    failed = [f"rank {r} exited {p.returncode}:\n"
              f"{(d / f'rank{r}.log').read_text()[-3000:]}"
              for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise AssertionError("train_sharded_2rank: " + "\n".join(failed))
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(len(procs))]
    one = ranks[0]["one_rank"]
    wrong = []
    for name, got in ranks[0]["meshes"].items():
        for s in range(SHARDED_STEPS):
            for r in ranks:
                mine = r["meshes"][name]
                at = f"{name} step {s + 1} rank {r['rank']}"
                diff = mine["max_abs_diff"][s]
                if not diff <= got["bound"][s]:   # NaN fails too
                    wrong.append(f"{at}: params {diff} > {got['bound'][s]}")
                if not mine["grad_rel_err"][s] <= SHARDED_GRAD_REL:
                    wrong.append(f"{at}: gradient {mine['grad_rel_err'][s]}"
                                 f" > {SHARDED_GRAD_REL}")
                if not mine["mean_abs_diff"][s] <= SHARDED_MEAN_DIFF:
                    wrong.append(f"{at}: mean |param diff| "
                                 f"{mine['mean_abs_diff'][s]} > "
                                 f"{SHARDED_MEAN_DIFF}")
            if abs(got["loss"][s] - one["loss"][s]) > 2 ** -7 * one["loss"][s]:
                wrong.append(f"{name} step {s + 1}: loss {got['loss'][s]} "
                             f"against {one['loss'][s]}")
            if abs(got["grad_norm"][s] - one["grad_norm"][s]) > \
                    5e-2 * one["grad_norm"][s]:
                wrong.append(f"{name} step {s + 1}: grad norm "
                             f"{got['grad_norm'][s]} against "
                             f"{one['grad_norm'][s]}")
        for r in ranks:
            n = r["meshes"][name]["launches"]
            if not n["flash_attention"] or not n["flash_attention_bwd"]:
                wrong.append(f"{name} rank {r['rank']}: launches {n}")
            if r["meshes"][name]["loss"] != got["loss"]:
                wrong.append(f"{name}: ranks' losses differ")
    for r in ranks:
        for name, rs in r["restores"].items():
            if rs["step"] != SHARDED_STEPS or not rs["bit_equal"] or \
                    not np.isfinite(rs["next_loss"]):
                wrong.append(f"restore on {name} rank {r['rank']}: {rs}")
        # head-parallel: each rank holds half the weights and gradients
        # and gathers none, so its step's peak falls below (2, 1)'s
        tp, dp = r["meshes"]["1x2"], r["meshes"]["2x1"]
        if not tp["step_peak_bytes"] < dp["step_peak_bytes"]:
            wrong.append(f"rank {r['rank']}: (1, 2) step peak "
                         f"{tp['step_peak_bytes']} not below (2, 1)'s "
                         f"{dp['step_peak_bytes']}")
        f = r["tp_forward"]
        if not (f["layer0_bit_equal"] and f["logits_rel_err"] <= TP_LOGITS_REL
                and f["near_ties_only"] and f["int8_launches"]):
            wrong.append(f"rank {r['rank']}: the (1, 2) mpai forward {f}")
    if wrong:
        raise AssertionError(f"train_sharded_2rank: {wrong}")
    for name, got in ranks[0]["meshes"].items():
        emit("train_sharded_2rank", card=card, config="stablelm-1.6b",
             plan="bf16", mesh=[int(x) for x in name.split("x")],
             backend="gloo", world=2, fsdp=True, layers=SHARDED_LAYERS,
             shape={"seq_len": TRAIN_SHAPE[0], "batch": TRAIN_SHAPE[1]},
             reduced=[f"layers 24 -> {SHARDED_LAYERS}",
                      f"global batch 256 -> {TRAIN_SHAPE[1]}",
                      f"grad_accum 1 -> {SHARDED_ACCUM} (two ranks on one "
                      f"card)"],
             loss=got["loss"], grad_norm=got["grad_norm"],
             one_rank_loss=one["loss"], one_rank_grad_norm=one["grad_norm"],
             max_abs_param_diff=[max(r["meshes"][name]["max_abs_diff"][s]
                                     for r in ranks)
                                 for s in range(SHARDED_STEPS)],
             mean_abs_param_diff=[r["meshes"][name]["mean_abs_diff"]
                                  for r in ranks],
             mean_abs_param_bound=SHARDED_MEAN_DIFF,
             param_bound=got["bound"],
             grad_rel_err=[r["meshes"][name]["grad_rel_err"] for r in ranks],
             grad_rel_bound=SHARDED_GRAD_REL,
             grad_bit_equal=[r["meshes"][name]["grad_equal"] for r in ranks],
             step_ms_each=[r["meshes"][name]["step_ms"] for r in ranks],
             collective_ms_each=[r["meshes"][name]["collective_ms"]
                                 for r in ranks],
             save_snapshot_s=got.get("save_snapshot_s"),
             compute=("head-parallel" if name == "1x2" else "replicated"),
             step_peak_gb=[r["meshes"][name]["step_peak_bytes"] / 1e9
                           for r in ranks],
             step_only_peak_gb=[r["meshes"][name]["step_only_peak_bytes"]
                                / 1e9 for r in ranks],
             launches=[r["meshes"][name]["launches"] for r in ranks],
             note="gloo stages CUDA tensors through host memory: "
                  "correctness runs, not speeds")
    emit("tp_forward", card=card, config="stablelm-1.6b", plan="mpai",
         mesh=[1, 2], layers=SHARDED_LAYERS, weights="the (2, 1) run's",
         logits_rel_bound=TP_LOGITS_REL,
         ranks=[r["tp_forward"] for r in ranks])
    emit("train_sharded_restore", card=card, saved_on=[2, 1],
         restores={f"rank{r['rank']}": r["restores"] for r in ranks},
         stage_s={f"rank{r['rank']}": r["stage_s"] for r in ranks},
         wall_s=wall)
    out = {f"stablelm-1.6b/train_sharded_2rank/{name}": got["launches"]
           for name, got in ranks[0]["meshes"].items()}
    out["stablelm-1.6b/tp_forward/1x2/mpai"] = {
        k: n for k, n in ranks[0]["tp_forward"]["launches"].items() if n}
    for p in OLMOE_PLANS:
        for mesh, n in olmoe_sharded_check(
                card, [r["olmoe"][p] for r in ranks], p).items():
            out[f"olmoe-1b-7b/train_sharded_2rank/{mesh}"
                + ("" if p == "mpai" else f"/{p}")] = n
    for key in RECURRENT_RUNS:
        name = recurrent_config(key).name
        for p in RECURRENT_PLANS:
            for mesh, n in recurrent_sharded_check(
                    card, [r["recurrent"][key][p] for r in ranks], key,
                    p).items():
                out[f"{name}/{key}_sharded_2rank/{mesh}/{p}"] = {
                    k: v for k, v in n.items() if v}
    for p in LAYER_GATHER_PLANS:
        for mesh, n in layer_gather_check(
                card, [r["layer_gather"][p] for r in ranks], p).items():
            out[f"stablelm-1.6b/layer_gather_2rank/{mesh}/{p}"] = {
                k: v for k, v in n.items() if v}
    measured = {f"stablelm-1.6b/{name}": [
        r["meshes"][name]["step_only_peak_bytes"] for r in ranks]
        for name in ranks[0]["meshes"]}
    for key in RECURRENT_RUNS:
        measured[f"{key}/1x2/{RECURRENT_TRACED}"] = [
            r["recurrent"][key][RECURRENT_TRACED]["1x2"]["step_only_peak_bytes"]
            for r in ranks]
    for p in OLMOE_PLANS:
        for mesh in OLMOE_MESHES:
            measured[f"olmoe-1b-7b/{mesh}/{p}"] = [
                r["olmoe"][p]["runs"][mesh]["step_only_peak_bytes"]
                for r in ranks]
    per_block = [r["layer_gather"][LAYER_GATHER_TRACED]["2x1"] for r in ranks]
    measured[f"stablelm-1.6b/layer_gather/2x1/{LAYER_GATHER_TRACED}"] = [
        x["step_only_peak_bytes"] for x in per_block]
    measured[f"stablelm-1.6b/layer_gather/2x1/{LAYER_GATHER_TRACED}"
             "/all_gathers"] = [len(x["gathers"]) for x in per_block]
    return out, measured


def held_step_faults(at: str, got: dict, want: dict, s: int, loss_rel,
                     norm_rel, grad_rel) -> list:
    """What fails of held two-rank step ``s`` (it starts from the one-rank
    run's state) against the one-rank run ``want``: the loss within
    ``loss_rel`` and the grad norm within ``norm_rel`` relative, the
    largest gradient slice's relative L2 error (``got["grad_rel_err"]``)
    within ``grad_rel``; a bound of None is not held."""
    wrong = []
    for k, rel in (("loss", loss_rel), ("grad_norm", norm_rel)):
        # NaN fails too
        if rel is not None and not abs(got[k][s] - want[k][s]) <= \
                rel * abs(want[k][s]):
            wrong.append(f"{at}: {k} {got[k][s]} against {want[k][s]} "
                         f"(bound {rel})")
    if grad_rel is not None and not got["grad_rel_err"][s] <= grad_rel:
        wrong.append(f"{at}: gradient {got['grad_rel_err'][s]} > {grad_rel}")
    return wrong


def held_params_faults(at: str, got: dict, tc, mean_bound: float) -> list:
    """What fails of where a two-rank run's parameters stood from the
    one-rank run's after each step but the last: their max |diff| within
    ``sharded_tolerance``, their mean within ``mean_bound``."""
    wrong = []
    for s, (hi, mean) in enumerate(zip(got["max_abs_diff"],
                                       got["mean_abs_diff"])):
        bound = sharded_tolerance(tc, s + 1)
        if not (hi <= bound and mean <= mean_bound):
            wrong.append(f"{at} after step {s + 1}: params max |diff| {hi} "
                         f"(bound {bound}), mean {mean} (bound "
                         f"{mean_bound})")
    return wrong


def olmoe_sharded_check(card: str, ranks: list, plan_name: str) -> dict:
    """``olmoe_sharded_2rank`` under ``plan_name``: each rank's two-rank
    runs against its one-rank run (``olmoe_rank``).  Each held step (from
    the one-rank run's state) of (2, 1) and of (1, 2) (expert-parallel,
    on the one-rank run's experts; its own router's picks part from them
    only at near-ties): the loss within ``OLMOE_LOSS_REL`` and each MoE
    call's aux loss within
    ``OLMOE_AUX_REL`` relative, the grad norm within 5e-2 relative, each
    gradient slice within ``SHARDED_GRAD_REL``, every MoE call through the
    per-row path in both runs, each row's dropped slots equal but at a
    near-tie (``route_differences``), the ranks' histories equal and the
    flash kernels launched; after each step but the last, the parameters'
    max |diff| within ``sharded_tolerance`` and their mean within
    ``SHARDED_MEAN_DIFF``.  Each (1, 2) step's peak lies below (2, 1)'s
    on each rank.  Each free step of (2, 1) (from the two-rank state): the
    per-row path, the loss within 2**-7 and the grad norm within 5e-2
    relative; its routes and gradient are reported beside where the
    parameters parted.  Returns rank 0's launches by mesh."""
    from repro_torch.configs.base import TrainConfig
    tc = TrainConfig(total_steps=OLMOE_STEPS)
    wrong = []

    def near(got, want, rel):
        return abs(got - want) <= rel * abs(want)
    for r, res in enumerate(ranks):
        one = res["runs"]["1x1"]
        for name in OLMOE_MESHES:
            mesh = res["runs"][name]
            wrong += [f"rank {r} {name}: {w}" for w in res["route_wrong"][name]]
            for s in range(OLMOE_STEPS):
                at = f"rank {r} {name} step {s + 1}"
                wrong += held_step_faults(at, mesh, one, s, OLMOE_LOSS_REL,
                                          5e-2, SHARDED_GRAD_REL)
                if len(mesh["aux"][s]) != len(one["aux"][s]) or not all(
                        near(a, b, OLMOE_AUX_REL)
                        for a, b in zip(mesh["aux"][s], one["aux"][s])):
                    wrong.append(f"{at}: aux {mesh['aux'][s]} against "
                                 f"{one['aux'][s]}")
            wrong += held_params_faults(f"rank {r} {name}", mesh, tc,
                                        SHARDED_MEAN_DIFF)
            if not mesh["per_row"] or not all(mesh["per_row"]):
                wrong.append(f"rank {r} {name}: dispatch per row "
                             f"{mesh['per_row']}")
            n = mesh["launches"]
            if not n["flash_attention"] or not n["flash_attention_bwd"]:
                wrong.append(f"rank {r} {name}: launches {n}")
            if mesh["loss"] != ranks[0]["runs"][name]["loss"]:
                wrong.append(f"{name}: the ranks' losses differ")
        free = res["runs"]["2x1"]["free"]
        for i, s in enumerate(range(1, OLMOE_STEPS)):
            at = f"rank {r} free step {s + 1}"
            if not near(free["loss"][i], one["loss"][s], 2 ** -7):
                wrong.append(f"{at}: loss {free['loss'][i]} against "
                             f"{one['loss'][s]}")
            if not near(free["grad_norm"][i], one["grad_norm"][s], 5e-2):
                wrong.append(f"{at}: grad norm {free['grad_norm'][i]} "
                             f"against {one['grad_norm'][s]}")
        if not free["per_row"] or not all(free["per_row"]):
            wrong.append(f"rank {r}: free dispatch per row "
                         f"{free['per_row']}")
        tp, dp = res["runs"]["1x2"], res["runs"]["2x1"]
        if not tp["step_peak_bytes"] < dp["step_peak_bytes"]:
            wrong.append(f"rank {r}: (1, 2) step peak {tp['step_peak_bytes']}"
                         f" not below (2, 1)'s {dp['step_peak_bytes']}")
    if wrong:
        raise AssertionError(f"olmoe_sharded_2rank: {wrong}")
    one = ranks[0]["runs"]["1x1"]
    free = [r["runs"]["2x1"]["free"] for r in ranks]
    for name in OLMOE_MESHES:
        mesh = ranks[0]["runs"][name]
        runs = [r["runs"][name] for r in ranks]
        extra = {} if name != "2x1" else dict(
            held="each later two-rank step starts from the one-rank run's "
                 "state; it is also run freely from the two-rank state "
                 "(free_*)",
            parting_after_step=[x["parting"] for x in runs],
            free_loss=free[0]["loss"], free_grad_norm=free[0]["grad_norm"],
            free_aux=free[0]["aux"],
            free_grad_rel_err=[f["grad_rel_err"] for f in free],
            free_routes=[f["routes"] for f in free],
            free_step_ms_each=[f["step_ms"] for f in free])
        if name == "1x2":
            extra["held"] = ("each later step starts from the one-rank run's "
                             "state; every step takes the one-rank run's "
                             "experts, its own router's picks are checked "
                             "apart (near_ties)")
        emit("olmoe_sharded_2rank", card=card, config="olmoe-1b-7b",
             plan=plan_name, mesh=[int(x) for x in name.split("x")],
             compute=("expert-parallel" if name == "1x2" else "replicated"),
             backend="gloo", world=2, layers=OLMOE_LAYERS,
             shape={"seq_len": OLMOE_SHAPE[0], "batch": OLMOE_SHAPE[1]},
             reduced=[f"layers 16 -> {OLMOE_LAYERS}",
                      f"train_4k's 256 x 4096 -> {OLMOE_SHAPE[1]} x "
                      f"{OLMOE_SHAPE[0]} (t * k 8192: the per-row path, "
                      f"which a rank's 4096 alone would not take)"],
             loss=mesh["loss"], one_rank_loss=one["loss"],
             loss_rel_bound=OLMOE_LOSS_REL,
             grad_norm=mesh["grad_norm"],
             one_rank_grad_norm=one["grad_norm"],
             aux=mesh["aux"], one_rank_aux=one["aux"],
             aux_rel_bound=OLMOE_AUX_REL,
             grad_rel_err=[x["grad_rel_err"] for x in runs],
             grad_rel_bound=SHARDED_GRAD_REL,
             max_abs_param_diff=[x["max_abs_diff"] for x in runs],
             mean_abs_param_diff=[x["mean_abs_diff"] for x in runs],
             mean_abs_param_bound=SHARDED_MEAN_DIFF,
             dropped_slots_by_call=[x["dropped"] for x in runs],
             near_ties=[r["near_ties"][name] for r in ranks],
             near_tie_bound=ROUTE_NEAR_TIE,
             step_ms_each=[x["step_ms"] for x in runs],
             one_rank_step_ms=one["step_ms"],
             collective_ms_each=[x["collective_ms"] for x in runs],
             step_peak_gb=[x["step_peak_bytes"] / 1e9 for x in runs],
             step_only_peak_gb=[x["step_only_peak_bytes"] / 1e9
                                for x in runs],
             launches=[x["launches"] for x in runs],
             note="gloo stages CUDA tensors through host memory: a "
                  "correctness run, not a speed; the routing record syncs "
                  "the host at each MoE call", **extra)
    return {name: ranks[0]["runs"][name]["launches"]
            for name in OLMOE_MESHES}


RECURRENT_LAYERS = 2             # the head-parallel recurrent runs' depth
RECURRENT_SHAPE = (512, 2)       # seq, global batch
RECURRENT_STEPS = 2
RECURRENT_PLANS = ("f32", "mpai", "bf16")
RECURRENT_RUNS = ("rwkv", "mamba")
# A held (1, 2) step's bounds against the one-rank run's: the loss and the
# grad norm (relative), each gradient slice (relative L2), and before the
# next step the parameters' mean |diff| (their max within
# ``sharded_tolerance``); None: reported, not held.  A missing, flipped or
# foreign gradient slice parts its leaf by 1, 2 or ~1.4.
# - f32 holds the split: its row-parallel sums add the same f32 terms in
#   another order, and RWKV-6 at full width moves by ~2e-5 in f32 when its
#   embedding moves by 2**-20 (tests/rwkv6_plan_norms.py);
# - the bf16 plans hold Jamba's Mamba layers to OLMoE's bounds, the loss's
#   raised to 1e-4: the row-parallel sums round to bf16 once, in another
#   order (3.6e-5 under "mpai" on an H100);
# - RWKV-6's gradients under the bf16 plans move by percents, some leaves
#   wholly, when its inputs move by an ulp (the reference's too:
#   tests/rwkv6_plan_norms.py; a (1, 2) step's leaves parted by up to 1.35
#   and its grad norm by 13% on an H100), so its f32 run holds its split
#   gradient and these runs hold the loss; the parameters' mean |diff|
#   counts the first Adam steps whose sign rounding turned (1.05e-7 under
#   bf16 on an H100) and is held within a quarter of the ~1.5e-6 a wrong
#   gradient gives (``SHARDED_MEAN_DIFF``'s note)
_F32_HOLD = {"loss": 1e-5, "grad_norm": 1e-5, "leaf": 1e-4,
             "mean": SHARDED_MEAN_DIFF}
_BF16_HOLD = {"loss": 1e-4, "grad_norm": 5e-2, "leaf": SHARDED_GRAD_REL,
              "mean": SHARDED_MEAN_DIFF}
RECURRENT_BOUNDS = {
    ("rwkv", "f32"): _F32_HOLD, ("mamba", "f32"): _F32_HOLD,
    ("mamba", "mpai"): _BF16_HOLD, ("mamba", "bf16"): _BF16_HOLD,
    **{("rwkv", p): {"loss": 1e-4, "grad_norm": None, "leaf": None,
                     "mean": 4e-7} for p in ("mpai", "bf16")}}
# the plan whose (1, 2) runs the dry run traces (the others differ from it
# in the GEMMs' dtype alone)
RECURRENT_TRACED = "mpai"
# the rank's heads and channels the (1, 2) runs' kernels must see
RECURRENT_KERNELS = {"rwkv": ("wkv", "wkv_bwd"),
                     "mamba": ("selective_scan", "selective_scan_bwd")}


def recurrent_config(key: str):
    """``rwkv``: RWKV-6 3B at full width (d 2560, 40 heads of 64, d_ff
    8960, vocab 65536), ``RECURRENT_LAYERS`` deep.  ``mamba``: Jamba-v0.1's
    Mamba layers at full width (d 4096, d_inner 8192, N 16, dt rank 256,
    its dense MLP of 14336, vocab 65536, ``grad_accum=2``), as deep,
    without its experts and its attention layer (``mixer="mamba"``,
    ``moe=None``): eight layers of Jamba with its 16 experts are ~51 GB of
    f32 parameters and do not train on one card; expert-parallel MoE is
    held on OLMoE."""
    if key == "rwkv":
        from repro_torch.configs.rwkv6_3b import FULL
        return FULL.with_(num_layers=RECURRENT_LAYERS)
    from repro_torch.configs.jamba_v0_1_52b import FULL
    return FULL.with_(num_layers=RECURRENT_LAYERS, mixer="mamba", moe=None)


class RecurrentShapes:
    """While entered, the input shapes of the model's wkv and
    selective-scan calls (``ops.wkv``'s r ``[B, S, H, N]``,
    ``ops.selective_scan``'s x ``[B, S, D]``); the wrappers' launch counts
    are untouched."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.real = {n: getattr(ops, n) for n in ("wkv", "selective_scan")}
        self.seen = {n: set() for n in self.real}

        def seen(name, fn):
            def call(*a, **kw):
                self.seen[name].add(tuple(a[0].shape))
                return fn(*a, **kw)
            return call
        for name, fn in self.real.items():
            setattr(ops, name, seen(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)

    def shapes(self) -> dict:
        return {n: sorted(v) for n, v in self.seen.items() if v}


def recurrent_rank(rank: int, dev, key: str, plan_name: str) -> dict:
    """One rank of ``<key>_sharded_2rank`` (``recurrent_config(key)``):
    ``RECURRENT_STEPS`` steps of ``plan_name`` on the 2 x 512 global batch
    on (1, 1), then on (1, 2), head-parallel (the same weights, from
    ``tc.seed``): each step's loss, grad norm, step ms, the collectives'
    ms, the step's peak and the shapes the recurrent kernels see, and on
    (1, 2) the largest relative L2 error of a gradient slice, as AdamW
    gets it, against the same slice of the one-rank gradient.  Every later
    (1, 2) step is held: it starts from the one-rank run's state, after
    noting where the parameters stand from it.  The one-rank runs of the
    two ranks take turns, and each keeps only its rank's slices of the
    gradients and state (the (1, 2) ``Trainer`` is made first for them):
    a one-rank run of Jamba's two full-width layers holds ~40 GB with its
    AdamW moments, too much for two at once on one card.  Returns what the
    parent checks."""
    import torch.distributed as dist
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.train_loop import Trainer

    cfg = recurrent_config(key)
    shape = ShapeConfig(f"{key}_2x512", *RECURRENT_SHAPE, "train")
    tc = TrainConfig(total_steps=RECURRENT_STEPS)
    n = cfg.num_layers
    plan = {"mpai": lambda: qat.train_plan(PartitionPlan.mpai(n)),
            "f32": lambda: PartitionPlan.uniform(n, PrecisionPolicy.fp32()),
            "bf16": lambda: None}[plan_name]()
    axes = ("data", "model")
    tp = Trainer(cfg, shape, MeshConfig((1, 2), axes), tc, plan=plan,
                 device=dev)
    one = Trainer(cfg, shape, MeshConfig((1, 1), axes), tc, plan=plan,
                  device=dev)
    specs = tree_leaves(tp.param_specs)
    runs, ref, starts = {}, [], []

    def drive(name, tr):
        st = tr.init_state()
        names = leaf_names(st.params)
        run = runs[name] = {"loss": [], "grad_norm": [], "step_ms": [],
                            "collective_ms": [], "grad_rel_err": [],
                            "worst_leaf": [], "max_abs_diff": [],
                            "mean_abs_diff": [], "kernel_shapes": []}
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                 # this rank's main path starts here
        for s in range(RECURRENT_STEPS):
            if name == "1x2" and s:
                diffs = [(a.float() - b.float()).abs() for a, b in zip(
                    tree_leaves(st.params), tree_leaves(starts[s - 1].params))]
                run["max_abs_diff"].append(max(float(x.max()) for x in diffs))
                run["mean_abs_diff"].append(
                    sum(float(x.sum()) for x in diffs)
                    / sum(x.numel() for x in diffs))
                del diffs
                for dst, src in zip(tree_leaves(st),
                                    tree_leaves(starts[s - 1])):
                    dst.copy_(src)
            spent, seen = [], []
            batch = lm_batch(cfg, shape, s, device=dev)
            torch.cuda.synchronize()
            held = step_peak_start(st)
            t0 = time.perf_counter()
            with timed_collectives(spent), kept_grads(seen), \
                    RecurrentShapes() as shapes:
                st, m = tr.step_fn(st, batch)
            torch.cuda.synchronize()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            step_peak_end(run, held)
            run["collective_ms"].append(sum(spent))
            run["loss"].append(float(m["loss"]))
            run["grad_norm"].append(float(m["grad_norm"]))
            run["kernel_shapes"].append(shapes.shapes())
            if name == "1x1":
                # this rank's (1, 2) slices of the whole gradient
                ref.append([g[tp.param_shardings.slices(sp, g.shape)].clone()
                            for g, sp in zip(seen[0], specs)])
                if s + 1 < RECURRENT_STEPS:
                    starts.append(tree_map(torch.clone,
                                           tp.state_shardings.shard(st)))
            else:
                errs = [float(torch.linalg.vector_norm(g.float() - w.float())
                              / torch.linalg.vector_norm(w.float()))
                        for g, w in zip(seen[0], ref[s])]
                i = int(np.argmax(errs))
                run["grad_rel_err"].append(errs[i])
                run["worst_leaf"].append(names[i])
            del seen, batch
        run["launches"] = launch_counts()
        del st
        gc.collect()
        torch.cuda.empty_cache()

    for turn in range(2):
        if turn == rank:
            drive("1x1", one)
        dist.barrier()
    drive("1x2", tp)
    del ref, starts, one, tp
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def recurrent_sharded_check(card: str, ranks: list, key: str,
                            plan_name: str) -> dict:
    """``<key>_sharded_2rank`` under ``plan_name``: each rank's (1, 2) run
    against its one-rank run (``recurrent_rank``).  Each held step within
    ``RECURRENT_BOUNDS[key, plan_name]`` (``held_step_faults``), and before
    it the parameters (``held_params_faults``); the ranks' histories equal;
    the kernels of ``RECURRENT_KERNELS[key]`` launched as often as on one
    rank (forward twice a layer and microbatch, remat's recompute writing
    the checkpoints, the backward once) at the rank's heads or channels;
    each rank's step-only peak below the one-rank run's.  Emits the run's
    line, then raises if a check failed.  Returns rank 0's launches by
    mesh."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models.rwkv import rwkv_dims
    tc = TrainConfig(total_steps=RECURRENT_STEPS)
    cfg = recurrent_config(key)
    bound = RECURRENT_BOUNDS[key, plan_name]
    fwd, bwd = RECURRENT_KERNELS[key]
    per_step = cfg.num_layers * cfg.grad_accum
    want = {fwd: 2 * per_step * RECURRENT_STEPS,
            bwd: per_step * RECURRENT_STEPS}
    rows = RECURRENT_SHAPE[1] // cfg.grad_accum
    if key == "rwkv":
        hp, hn, _ = rwkv_dims(cfg, 2)
        local = [rows, RECURRENT_SHAPE[0], hp // 2, hn]
    else:
        local = [rows, RECURRENT_SHAPE[0],
                 cfg.mamba.expand * cfg.d_model // 2]
    wrong = []
    for r, res in enumerate(ranks):
        one, mesh = res["1x1"], res["1x2"]
        for s in range(RECURRENT_STEPS):
            at = f"rank {r} step {s + 1}"
            wrong += held_step_faults(at, mesh, one, s, bound["loss"],
                                      bound["grad_norm"], bound["leaf"])
            if mesh["kernel_shapes"][s].get(fwd) != [local]:
                wrong.append(f"{at}: kernels saw {mesh['kernel_shapes'][s]}"
                             f", not {local}")
        wrong += held_params_faults(f"rank {r}", mesh, tc, bound["mean"])
        for name in ("1x1", "1x2"):
            n = res[name]["launches"]
            if any(n[k] != v for k, v in want.items()):
                wrong.append(f"rank {r} {name}: launches {n}, not {want}")
        if mesh["loss"] != ranks[0]["1x2"]["loss"]:
            wrong.append("the ranks' losses differ")
        if not mesh["step_only_peak_bytes"] < one["step_only_peak_bytes"]:
            wrong.append(f"rank {r}: (1, 2) step peak "
                         f"{mesh['step_only_peak_bytes']} not below one "
                         f"rank's {one['step_only_peak_bytes']}")
    one = ranks[0]["1x1"]
    runs = [r["1x2"] for r in ranks]
    emit(f"{key}_sharded_2rank", card=card, config=cfg.name,
         plan=plan_name, mesh=[1, 2], compute="head-parallel",
         backend="gloo", world=2, layers=RECURRENT_LAYERS,
         shape={"seq_len": RECURRENT_SHAPE[0],
                "batch": RECURRENT_SHAPE[1]},
         reduced=([f"layers 32 -> {RECURRENT_LAYERS}",
                   f"train_4k's 256 x 4096 -> {RECURRENT_SHAPE[1]} x "
                   f"{RECURRENT_SHAPE[0]}"]
                  + ([] if key == "rwkv" else [
                      "mixer hybrid -> mamba, moe None: Jamba's Mamba "
                      "layers and dense MLP at full width, without its 16 "
                      "experts and its attention layer (8 layers with "
                      "experts, ~51 GB of f32 parameters, do not train on "
                      "one card; expert-parallel MoE is olmoe_sharded_"
                      "2rank's)"])),
         held="each later step starts from the one-rank run's state",
         loss=runs[0]["loss"], one_rank_loss=one["loss"],
         grad_norm=runs[0]["grad_norm"],
         one_rank_grad_norm=one["grad_norm"],
         grad_rel_err=[x["grad_rel_err"] for x in runs],
         worst_leaf=[x["worst_leaf"] for x in runs],
         bounds=bound,
         max_abs_param_diff=[x["max_abs_diff"] for x in runs],
         param_bound=[sharded_tolerance(tc, s + 1)
                      for s in range(RECURRENT_STEPS - 1)],
         mean_abs_param_diff=[x["mean_abs_diff"] for x in runs],
         kernel_shapes=runs[0]["kernel_shapes"][0],
         one_rank_kernel_shapes=one["kernel_shapes"][0],
         step_ms_each=[x["step_ms"] for x in runs],
         one_rank_step_ms=one["step_ms"],
         collective_ms_each=[x["collective_ms"] for x in runs],
         step_peak_gb=[x["step_peak_bytes"] / 1e9 for x in runs],
         step_only_peak_gb=[x["step_only_peak_bytes"] / 1e9 for x in runs],
         one_rank_step_only_peak_gb=[r["1x1"]["step_only_peak_bytes"] / 1e9
                                     for r in ranks],
         launches=[x["launches"] for x in runs], failed=wrong,
         note="gloo stages CUDA tensors through host memory: a "
              "correctness run, not a speed")
    if wrong:
        raise AssertionError(f"{key}_sharded_2rank {plan_name}: {wrong}")
    return {name: ranks[0][name]["launches"] for name in ("1x1", "1x2")}


LAYER_GATHER_LAYERS = 4          # the per-block run's depth (4 blocks)
LAYER_GATHER_SHAPE = (512, 2)    # seq, global batch: a row a rank
LAYER_GATHER_PLANS = ("f32", "bf16")
# a (2, 1) step against the one-rank step from the same state: the
# recurrent runs' bounds (f32 holds the split tightly; bf16 at OLMoE's)
LAYER_GATHER_BOUNDS = {"f32": _F32_HOLD, "bf16": _BF16_HOLD}
# the plan whose run the dry run traces (it has no f32 plan)
LAYER_GATHER_TRACED = "bf16"


def layer_gather_config():
    """StableLM-2 1.6B at full width (d 2048, 32 heads of 64, d_ff 5632,
    vocab 100352, remat) with ``fsdp=True``, ``LAYER_GATHER_LAYERS``
    deep: on (2, 1) the data axis splits every projection of the stacked
    layers, so the step gathers them one super-block at a time."""
    from repro_torch.configs.stablelm_1_6b import FULL
    return FULL.with_(num_layers=LAYER_GATHER_LAYERS, fsdp=True)


def layer_gather_rank(rank: int, dev, plan_name: str) -> dict:
    """One rank of ``layer_gather_2rank`` (``layer_gather_config()``): one
    step of ``plan_name`` on the 2 x 512 global batch on one device, then
    one on (2, 1) from the same seeded state, its stacked layers gathered a
    super-block at a time: each step's loss, grad norm, step ms, the
    collectives' ms, the step-only peak; on (2, 1) each data-axis
    all-gather's operand shape (``launch.dryrun.counted_collectives``),
    the stacked leaves' shapes, the largest relative L2 error of a
    gradient slice as AdamW gets it against the same slice of the
    one-device gradient, and the parameters' max and mean |diff| after
    the step.  Both ranks run the one-device step at once (~11 GB each).
    Returns what the parent checks."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.runtime.train_loop import Trainer

    cfg = layer_gather_config()
    shape = ShapeConfig("layer_gather_2x512", *LAYER_GATHER_SHAPE, "train")
    tc = TrainConfig(total_steps=1)
    plan = (PartitionPlan.uniform(cfg.num_layers, PrecisionPolicy.fp32())
            if plan_name == "f32" else None)
    axes = ("data", "model")
    dp = Trainer(cfg, shape, MeshConfig((2, 1), axes), tc, plan=plan,
                 device=dev)
    one = Trainer(cfg, shape, MeshConfig((1, 1), axes), tc, plan=plan,
                  device=dev)
    specs = tree_leaves(dp.param_specs)
    batch = lm_batch(cfg, shape, 0, device=dev)
    runs, want = {}, {}
    for name, tr in (("1x1", one), ("2x1", dp)):
        st = one.init_state()
        if name == "2x1":
            st = dp.state_shardings.shard(st)
        names = leaf_names(st.params)
        spent, seen, tally = [], [], dryrun.Tally()
        torch.cuda.synchronize()
        held = step_peak_start(st)
        zero_counts()                 # this rank's main path starts here
        t0 = time.perf_counter()
        with timed_collectives(spent), kept_grads(seen), \
                dryrun.counted_collectives(tally):
            st, m = tr.step_fn(st, batch)
        torch.cuda.synchronize()
        run = runs[name] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                            "collective_ms": sum(spent),
                            "loss": [float(m["loss"])],
                            "grad_norm": [float(m["grad_norm"])]}
        step_peak_end(run, held)
        run["launches"] = launch_counts()
        if name == "1x1":
            # this rank's (2, 1) slices of the gradient and parameters
            want["grads"] = [g[dp.param_shardings.slices(sp, g.shape)].clone()
                             for g, sp in zip(seen[0], specs)]
            want["params"] = [p[dp.param_shardings.slices(sp, p.shape)]
                              .clone() for p, sp in
                              zip(tree_leaves(st.params), specs)]
        else:
            errs = [float(torch.linalg.vector_norm(g.float() - w.float())
                          / torch.linalg.vector_norm(w.float()))
                    for g, w in zip(seen[0], want["grads"])]
            i = int(np.argmax(errs))
            run["grad_rel_err"], run["worst_leaf"] = [errs[i]], [names[i]]
            diffs = [(a.float() - b.float()).abs() for a, b in
                     zip(tree_leaves(st.params), want["params"])]
            run["max_abs_diff"] = [max(float(x.max()) for x in diffs)]
            run["mean_abs_diff"] = [sum(float(x.sum()) for x in diffs)
                                    / sum(x.numel() for x in diffs)]
            data = tuple(torch.distributed.get_process_group_ranks(
                dp.placement.group(("data",))))
            run["gathers"] = [list(shp) for kind, shp, ranks
                              in tally.coll_calls
                              if kind == "all-gather" and ranks == data]
            run["stacked"] = [list(t.shape) for t, blk in zip(
                tree_leaves(st.params), tree_leaves(dp.blocks.leaves))
                if blk]
            del diffs
        del st, seen
        gc.collect()
        torch.cuda.empty_cache()
    del want, dp, one, batch
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def layer_gather_passes(cfg) -> int:
    """How often one microbatch gathers each super-block: once in the
    forward, once in remat's recompute (no ``remat_group`` here)."""
    return 2 * cfg.num_layers if cfg.remat else cfg.num_layers


def layer_gather_check(card: str, ranks: list, plan_name: str) -> dict:
    """``layer_gather_2rank`` under ``plan_name``: each rank's (2, 1) step
    against its one-device step (``layer_gather_rank``).  The step within
    ``LAYER_GATHER_BOUNDS[plan_name]`` (``held_step_faults``: loss, grad
    norm, each gradient slice), the parameters after it within
    ``sharded_tolerance`` and the bound's mean; every data-axis
    all-gather's operand one super-block's part of a stacked leaf, each
    leaf's blocks gathered ``layer_gather_passes`` times and no stacked
    leaf gathered; the ranks' losses equal; the flash kernels launched;
    each rank's step-only peak below the one-device step's.  Emits the
    run's line, then raises if a check failed.  Returns rank 0's launches
    by mesh."""
    from repro_torch.configs.base import TrainConfig
    cfg = layer_gather_config()
    tc = TrainConfig(total_steps=1)
    bound = LAYER_GATHER_BOUNDS[plan_name]
    wrong = []
    for r, res in enumerate(ranks):
        one, mesh = res["1x1"], res["2x1"]
        at = f"rank {r}"
        wrong += held_step_faults(at, mesh, one, 0, bound["loss"],
                                  bound["grad_norm"], bound["leaf"])
        wrong += held_params_faults(at, mesh, tc, bound["mean"])
        want = {}
        for shp in mesh["stacked"]:
            key = tuple(shp[1:])
            want[key] = want.get(key, 0) + layer_gather_passes(cfg)
        got = {}
        for shp in mesh["gathers"]:
            got[tuple(shp)] = got.get(tuple(shp), 0) + 1
        if not mesh["stacked"] or got != want:
            wrong.append(f"{at}: data-axis all-gathers {got}, not {want}")
        for name in ("1x1", "2x1"):
            if not res[name]["launches"]["flash_attention"]:
                wrong.append(f"{at} {name}: launches {res[name]['launches']}")
        if mesh["loss"] != ranks[0]["2x1"]["loss"]:
            wrong.append("the ranks' losses differ")
        if not mesh["step_only_peak_bytes"] < one["step_only_peak_bytes"]:
            wrong.append(f"{at}: (2, 1) step peak "
                         f"{mesh['step_only_peak_bytes']} not below one "
                         f"device's {one['step_only_peak_bytes']}")
    runs = [r["2x1"] for r in ranks]
    emit("layer_gather_2rank", card=card, config=cfg.name, plan=plan_name,
         mesh=[2, 1], fsdp=True, backend="gloo", world=2,
         layers=LAYER_GATHER_LAYERS,
         execution="data-axis parts gathered one super-block at a time",
         shape={"seq_len": LAYER_GATHER_SHAPE[0],
                "batch": LAYER_GATHER_SHAPE[1]},
         reduced=[f"layers 24 -> {LAYER_GATHER_LAYERS}",
                  f"train_4k's 256 x 4096 -> {LAYER_GATHER_SHAPE[1]} x "
                  f"{LAYER_GATHER_SHAPE[0]}"],
         held="the step starts from the one-device run's state",
         loss=runs[0]["loss"], one_rank_loss=ranks[0]["1x1"]["loss"],
         grad_norm=runs[0]["grad_norm"],
         one_rank_grad_norm=ranks[0]["1x1"]["grad_norm"],
         grad_rel_err=[x["grad_rel_err"] for x in runs],
         worst_leaf=[x["worst_leaf"] for x in runs], bounds=bound,
         max_abs_param_diff=[x["max_abs_diff"] for x in runs],
         param_bound=sharded_tolerance(tc, 1),
         mean_abs_param_diff=[x["mean_abs_diff"] for x in runs],
         block_all_gathers=[len(x["gathers"]) for x in runs],
         stacked_leaves=len(runs[0]["stacked"]),
         passes_a_block=layer_gather_passes(cfg),
         step_ms_each=[x["step_ms"] for x in runs],
         one_rank_step_ms=[r["1x1"]["step_ms"] for r in ranks],
         collective_ms_each=[x["collective_ms"] for x in runs],
         step_peak_gb=[x["step_peak_bytes"] / 1e9 for x in runs],
         step_only_peak_gb=[x["step_only_peak_bytes"] / 1e9 for x in runs],
         one_rank_step_only_peak_gb=[r["1x1"]["step_only_peak_bytes"] / 1e9
                                     for r in ranks],
         launches=[x["launches"] for x in runs], failed=wrong,
         note="gloo stages CUDA tensors through host memory: a "
              "correctness run, not a speed")
    if wrong:
        raise AssertionError(f"layer_gather_2rank {plan_name}: {wrong}")
    return {name: ranks[0][name]["launches"] for name in ("1x1", "2x1")}


RWKV_TRAIN_STEPS = 3
RWKV_REPEAT_LAYERS = 2           # the repeated step's depth (two states)


def rwkv_train_full_width_phase(dev, card: str, wk, keep=None) -> dict:
    """RWKV-6 3B at full width and depth (32 layers, d 2560, 40 heads of
    64, vocab 65536, remat) trained ``RWKV_TRAIN_STEPS`` steps of
    ``RWKV_TRAIN_SHAPE`` under bf16 and "mpai" by ``train_plans``: every
    layer's wkv launched twice a step (the forward and remat's recompute,
    which writes the checkpoints) and its backward once.  Then one step
    from the same state run twice, ``RWKV_REPEAT_LAYERS`` deep at the same
    widths (two 3 B states and their moments do not fit one card): the
    parameters bit-equal.  ``keep`` receives the bf16 run's step times,
    state bytes and peak memory (``train_plans``) for ``dryrun``."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.rwkv6_3b import FULL
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.train_loop import Trainer

    shape = ShapeConfig("train_4k_cut", *RWKV_TRAIN_SHAPE, "train")
    layers = FULL.num_layers

    def check(n):
        want = {"wkv": 2 * layers * RWKV_TRAIN_STEPS,
                "wkv_bwd": layers * RWKV_TRAIN_STEPS}
        return [f"{k} launched {n[k]} times, not {v}"
                for k, v in want.items() if n[k] != v]
    out = train_plans(
        dev, card, FULL, shape, RWKV_TRAIN_STEPS, "rwkv_train_full_width",
        [f"global batch 256 -> {RWKV_TRAIN_SHAPE[1]} (one card)"],
        lambda: {"wkv": wk.wkv.launches, "wkv_bwd": wk.wkv_bwd.launches},
        check, keep, keep_params=False)

    cfg = FULL.with_(num_layers=RWKV_REPEAT_LAYERS)
    tr = Trainer(cfg, shape, MeshConfig((1, 1), ("data", "model")),
                 TrainConfig(total_steps=1), device=dev)
    batch = lm_batch(cfg, shape, 0, device=dev)
    runs = []
    for _ in range(2):
        state, m = tr.step_fn(tr.init_state(), batch)
        runs.append((tree_leaves(state.params), float(m["loss"]),
                     float(m["grad_norm"])))
        del state
    equal = all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    if not equal or runs[0][1:] != runs[1][1:]:
        raise AssertionError(f"rwkv_train_repeat: parameters equal {equal}, "
                             f"loss and grad norm {runs[0][1:]} against "
                             f"{runs[1][1:]}")
    emit("rwkv_train_repeat", card=card, config=cfg.name,
         layers=RWKV_REPEAT_LAYERS,
         reduced=[f"global batch 256 -> {RWKV_TRAIN_SHAPE[1]}",
                  f"layers 32 -> {RWKV_REPEAT_LAYERS}"],
         params_bit_equal=True, loss=runs[0][1], grad_norm=runs[0][2])
    del runs, tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


DRYRUN_PEAK_BAND = 0.10         # predicted peak within 10% of the measured


def dryrun_phase(card: str, measured: dict, two_rank: dict) -> None:
    """The dry run (``repro_torch.launch.dryrun``, a fake world of one rank
    on the CPU, no device) of the two bf16 training runs just measured:
    StableLM-2 1.6B at ``TRAIN_SHAPE`` and RWKV-6 3B at ``RWKV_TRAIN_SHAPE``
    on a (1, 1) mesh.  Its state bytes (the arguments less the batch) must
    equal the ``Trainer`` state's bytes on the card exactly, and its peak
    lie within ``DRYRUN_PEAK_BAND`` of the run's
    ``torch.cuda.max_memory_allocated()``.  Prints the roofline's terms,
    ``model_flops`` over the measured median step as a share of the bf16
    peak, and the dry run's seconds.  ``measured``: ``{arch: train_plans'
    keep}``.  Then ``dryrun_two_rank``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig, ShapeConfig
    from repro_torch.launch import dryrun, specs

    mesh = MeshConfig((1, 1), ("data", "model"))
    for arch, (seq, batch) in (("stablelm-1.6b", TRAIN_SHAPE),
                               ("rwkv6-3b", RWKV_TRAIN_SHAPE)):
        cfg, run = get_config(arch), measured[arch]
        shape = ShapeConfig("train_4k_cut", seq, batch, "train")
        t0 = time.perf_counter()
        with dryrun.fake_world(1):
            st = dryrun.trace_cell(cfg, shape, mesh)
        seconds = time.perf_counter() - t0
        batch_bytes = sum(t.numel() * t.element_size()
                          for t in specs.batch_specs(cfg, shape).values())
        state_bytes = st["argument_size_in_bytes"] - batch_bytes
        peak_err = st["peak_bytes"] / run["peak_bytes"] - 1
        step_ms = float(np.median(run["step_ms_each"])) * 1e3
        model_flops = roofline.model_flops(cfg, shape)
        row = st["roofline"]
        emit("dryrun", card=card, config=arch,
             shape={"seq_len": seq, "batch": batch}, mesh="1x1",
             plan="bf16", execution=st["execution"], dryrun_s=seconds,
             state_bytes_predicted=state_bytes,
             state_bytes_measured=run["state_bytes"],
             peak_bytes_predicted=st["peak_bytes"],
             peak_bytes_measured=run["peak_bytes"],
             peak_relative_err=peak_err, peak_band=DRYRUN_PEAK_BAND,
             temp_bytes_predicted=st["temp_size_in_bytes"],
             flops_predicted=st["flops"], kernel_flops=st["kernel_flops"],
             hlo_bytes_predicted=st["hlo_bytes"],
             kernel_calls=st["kernel_calls"],
             compute_ms=row["compute_ms"], memory_ms=row["memory_ms"],
             collective_ms=row["collective_ms"], dominant=row["dominant"],
             model_flops=model_flops, step_ms=step_ms,
             model_flops_share_of_bf16_peak=model_flops / (step_ms / 1e3)
             / roofline.PEAK_BF16)
        if state_bytes != run["state_bytes"]:
            raise AssertionError(f"dryrun {arch}: predicted state "
                                 f"{state_bytes} bytes, the Trainer's on "
                                 f"the card {run['state_bytes']}")
        if abs(peak_err) > DRYRUN_PEAK_BAND:
            raise AssertionError(f"dryrun {arch}: predicted peak "
                                 f"{st['peak_bytes']} bytes, measured "
                                 f"{run['peak_bytes']} ({peak_err:+.1%})")
    dryrun_two_rank(card, two_rank)


def dryrun_two_rank(card: str, two_rank: dict) -> None:
    """The (1, 2) runs of ``train_sharded_2rank``, which compute head- and
    expert-parallel (StableLM-2, OLMoE-1B-7B, and RWKV-6 and Jamba's Mamba
    layers on the rank's heads and channels, under ``RECURRENT_TRACED``),
    and the per-block (2, 1) run of ``layer_gather_2rank`` (under
    ``LAYER_GATHER_TRACED``), through the dry run as rank 0 of a fake
    world of two: the traced peak within ``DRYRUN_PEAK_BAND`` of the
    largest measured step of a rank, less what the rank held beside its
    state (``step_peak_end``; ``two_rank``: ``{run: [bytes a rank]}``),
    and where ``two_rank`` has ``{run}/all_gathers``, the traced
    all-gathers as many as each rank made."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig
    from repro_torch.configs.olmoe_1b_7b import FULL as OLMOE
    from repro_torch.configs.stablelm_1_6b import FULL as STABLELM
    from repro_torch.launch import dryrun
    tp_mesh = MeshConfig((1, 2), ("data", "model"))
    dp_mesh = MeshConfig((2, 1), ("data", "model"))
    per_block = f"stablelm-1.6b/layer_gather/2x1/{LAYER_GATHER_TRACED}"
    for key, cfg, (seq, batch), plan, mesh in (
            ("stablelm-1.6b/1x2", STABLELM.with_(
                num_layers=SHARDED_LAYERS, fsdp=True,
                grad_accum=SHARDED_ACCUM), TRAIN_SHAPE, "bf16", tp_mesh),
            *((f"olmoe-1b-7b/1x2/{p}", OLMOE.with_(num_layers=OLMOE_LAYERS),
               OLMOE_SHAPE, p, tp_mesh) for p in OLMOE_PLANS),
            *((f"{key}/1x2/{RECURRENT_TRACED}", recurrent_config(key),
               RECURRENT_SHAPE, RECURRENT_TRACED, tp_mesh)
              for key in RECURRENT_RUNS),
            (per_block, layer_gather_config(), LAYER_GATHER_SHAPE,
             LAYER_GATHER_TRACED, dp_mesh)):
        shape = ShapeConfig("two_rank", seq, batch, "train")
        t0 = time.perf_counter()
        with dryrun.fake_world(2):
            st = dryrun.trace_cell(cfg, shape, mesh, plan)
        seconds = time.perf_counter() - t0
        got = max(two_rank[key])
        peak_err = st["peak_bytes"] / got - 1
        emit("dryrun", card=card, config=cfg.name, run=key,
             shape={"seq_len": seq, "batch": batch},
             mesh="x".join(map(str, mesh.shape)), plan=plan,
             execution=st["execution"], dryrun_s=seconds,
             peak_bytes_predicted=st["peak_bytes"],
             peak_bytes_measured_each=two_rank[key],
             peak_relative_err=peak_err, peak_band=DRYRUN_PEAK_BAND,
             collective_counts=st["collective_counts"],
             all_gathers_measured_each=two_rank.get(f"{key}/all_gathers"),
             collective_bytes_by_link=st["collective_bytes_by_link"],
             kernel_calls=st["kernel_calls"])
        if abs(peak_err) > DRYRUN_PEAK_BAND:
            raise AssertionError(f"dryrun {key}: predicted peak "
                                 f"{st['peak_bytes']} bytes, measured "
                                 f"{got} ({peak_err:+.1%})")
        gathers = two_rank.get(f"{key}/all_gathers")
        if gathers is not None and any(
                n != st["collective_counts"].get("all-gather", 0)
                for n in gathers):
            raise AssertionError(f"dryrun {key}: traced all-gathers "
                                 f"{st['collective_counts']}, measured "
                                 f"{gathers} a rank")


# the train launcher on the card, each a main path of its own: the audio
# frontend (flash), Jamba's smoke config (the scan and its backward, flash
# and its backward, the MoE dispatch), RWKV-6's (wkv and its backward)
LAUNCH_TRAINS = {
    "musicgen-smoke": (["--arch", "musicgen-medium", "--smoke", "--steps",
                        "2"], ("flash_attention",
                               "flash_attention_bwd_mma_sync")),
    "jamba-smoke": (["--arch", "jamba-v0.1-52b", "--smoke", "--steps", "2"],
                    ("flash_attention", "flash_attention_bwd_mma_sync",
                     "selective_scan", "selective_scan_bwd")),
    "rwkv6-smoke": (["--arch", "rwkv6-3b", "--smoke", "--steps", "2"],
                    ("wkv", "wkv_bwd"))}


def launch_train_phase(card: str) -> dict:
    """``python -m repro_torch.launch.train`` at each of ``LAUNCH_TRAINS``
    on the card, as ``main(argv)``: two finite steps, each named kernel
    launched.  Returns ``{config: launches by row name}``, each run counted
    from 0."""
    import shutil
    import tempfile
    from repro_torch.launch import train
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    for config, (argv, kernels) in LAUNCH_TRAINS.items():
        ckpt_dir = tempfile.mkdtemp(prefix="launch_train_",
                                    dir=ROOT / "build")
        try:
            zero_counts()             # the main path's counts start here
            t0 = time.perf_counter()
            res = train.main(argv + ["--ckpt-dir", ckpt_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = launch_counts()
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        hist = res["history"]
        if [h["step"] for h in hist] != [1, 2] or not all(
                np.isfinite(h["loss"]) for h in hist):
            raise AssertionError(f"launch_train {config}: {hist}")
        idle = [k for k in kernels if not n[k]]
        if idle:
            raise AssertionError(f"launch_train {config}: no launch of "
                                 f"{idle}")
        emit("launch_train", card=card, argv=argv, wall_s=wall,
             arch=res["arch"], shape=res["shape"],
             loss=[h["loss"] for h in hist],
             **{f"{k}_launches": n[k] for k in kernels})
        out[config] = {k: n[k] for k in kernels}
    return out


def fleetlint_phase(build) -> None:
    """The port's static analyzer over this checkout (pure ``ast``, no
    device): clean against its baseline, counts by pass.  Then every
    kernel contract's ``extern "C"`` symbol looked up in the library
    built for the card (the static pass holds the wrappers' argtypes to
    the C signatures; this shows the symbols are real exports of the
    ``sm_90a`` build)."""
    from repro_torch.analysis import run_lint
    from repro_torch.analysis.passes.contracts import KERNEL_CONTRACTS

    t0 = time.perf_counter()
    report = run_lint(root=str(ROOT))
    lint_s = time.perf_counter() - t0
    unsuppressed = run_lint(root=str(ROOT), baseline_path=None)
    by_pass = collections.Counter(f.pass_id for f in unsuppressed.findings)
    resolved, missing = {}, []
    for sym, c in sorted(KERNEL_CONTRACTS.items()):
        lib = c.source.rsplit("/", 1)[-1][:-3]
        try:
            getattr(build.load(lib), sym)
        except AttributeError:
            missing.append(f"{sym} in {lib}")
        else:
            resolved[sym] = lib
    emit("fleetlint", files_scanned=report.files_scanned,
         findings=len(report.findings),
         stale_suppressions=len(report.stale_suppressions),
         parse_errors=len(report.parse_errors),
         suppressed=len(report.suppressed),
         baselined_by_pass=dict(sorted(by_pass.items())),
         lint_s=lint_s, contracts_resolved=len(resolved),
         libraries=sorted(set(resolved.values())))
    if not report.clean:
        raise AssertionError("fleetlint: " + "; ".join(
            [f"{f.path}:{f.line}: {f.code} {f.message}"
             for f in report.findings]
            + [f"stale {k}" for k in report.stale_suppressions]
            + [f"{p}: {e}" for p, e in report.parse_errors]))
    if missing or len(resolved) != 14:
        raise AssertionError(f"fleetlint: {len(resolved)} contracts "
                             f"resolved; missing {missing}")


def load_twin(name: str):
    """``examples_torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLE_QUICKSTART_STEPS = 50        # the example's 200 cut to 50
EXAMPLE_100M_STEPS = 30              # the fault at step 25, saved at 25


def run_twin(fn, *args):
    """One twin step on the card, its stdout kept and its launches
    counted from 0: ``(result, stdout lines, launches, wall s)``."""
    import io
    zero_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    torch.cuda.synchronize()
    return res, out.getvalue().splitlines(), launch_counts(), \
        time.perf_counter() - t0


def uninterrupted_100m(twin, cfg, state, steps: int, dev):
    """``train_100m``'s run without the fault, continued from ``state`` (the
    faulted run's checkpointed state) to ``steps``, with the twin's
    trainer: ``(state, the history of those steps)``."""
    from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.runtime.train_loop import Trainer
    shape = ShapeConfig("train", 512, 8, "train")
    tc = TrainConfig(learning_rate=6e-4, warmup_steps=30, total_steps=steps,
                     checkpoint_every=25)
    tr = Trainer(cfg, shape, MeshConfig((1, 1), ("data", "model")), tc,
                 plan=qat.train_plan(PartitionPlan.mpai(cfg.num_layers)),
                 device=dev)
    hist = []

    def observe(s, st, m):
        hist.append({"step": s + 1, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    state, _ = tr.run(state, lambda s: lm_batch(cfg, shape, s, device=dev),
                      steps - int(state.step), on_step=observe)
    return state, hist


def to_cpu(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t, tree)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(float(x)))) - 7)


def example_ties(what: str, cfg, cpu_params, plan, prompts, prompt_len: int,
                 cuda: dict, cpu: dict) -> int:
    """``near_tie_divergences`` of a twin's greedy streams, card against
    CPU: the CPU's top two logits over the left-padded prompt and the
    CPU's tokens before the parting."""
    from repro_torch.models import transformer as T

    def top2_of(rid, t):
        ctx = np.zeros(prompt_len, np.int32)
        ctx[-len(prompts[rid]):] = prompts[rid]
        ctx = np.concatenate([ctx, np.asarray(cpu[rid][:t], np.int32)])
        logits = T.forward(cpu_params, cfg, torch.as_tensor(ctx[None]),
                           plan).logits[0, -1].float()
        return torch.topk(logits, 2).values
    return near_tie_divergences(f"examples {what}",
                                {"cuda": cuda, "cpu": cpu},
                                [(rid, None, None) for rid in cuda], top2_of)


def examples_phase(dev, card: str, fa) -> dict:
    """The five twins of ``examples_torch/`` on the card, in-process, at
    the examples' widths; each checked as the reference example asserts
    (the cost-model twins assert inside ``main``); ``serve_partitioned``'s
    streams and ``quickstart``'s eval losses and stream held against the
    same weights on the CPU (plain versions), ``train_100m``'s faulted run
    bit-equal to an uninterrupted one.  Returns ``{twin run:
    launches by row name}``, each run counted from 0."""
    import shutil
    import tempfile
    from repro_torch.core.tree import tree_leaves

    out, wrong = {}, []

    def need(run: str, n: dict, rows) -> None:
        idle = [k for k in rows if not n[k]]
        if idle:
            wrong.append(f"{run}: no launch of {idle}")

    for name in ("route_failover", "orbit_eclipse"):
        res, lines, n, wall = run_twin(load_twin(name).main, [])
        snap = res if name == "route_failover" else res["telemetry"]
        emit("example", card=card, twin=name, wall_s=wall,
             admitted=snap["admitted"], completed=snap["completed"],
             dropped=snap["dropped"], stdout=lines[-6:])
        out[f"examples/{name}"] = n

    twin = load_twin("serve_partitioned")
    res, lines, n, wall = run_twin(twin.main, [])
    shards = res["imports_by_shard"]
    if sorted(res["tokens"]) != list(range(10)) or any(
            len(t) != 8 for t in res["tokens"].values()) or \
            sum(shards.values()) != 10 or min(shards.values()) < 1:
        wrong.append(f"serve_partitioned: {res}")
    # the split's prefill is chunked through the pool: no flash
    need("serve_partitioned", n, ("paged_attention", "int8_matmul"))
    # the same weights through the same fleet on the CPU (plain versions)
    cfg, cpu_params = res["cfg"], to_cpu(res["params"])
    with contextlib.redirect_stdout(None):
        client = twin.build_fleet(cfg, cpu_params, "cpu")
        cpu = twin.serve(client, cfg)
    ties = example_ties("serve_partitioned", cfg, cpu_params,
                        client.engines["board"].decode.plan,
                        twin.prompts(cfg), 16, res["tokens"], cpu["tokens"])
    if cpu["imports_by_shard"] != shards:
        wrong.append(f"serve_partitioned: imports by shard {shards} on the "
                     f"card, {cpu['imports_by_shard']} on the CPU")
    emit("example", card=card, twin="serve_partitioned", wall_s=wall,
         config="qwen3-smoke", layers=4, plan="mpai", plan_split=3,
         decode_shards=2, tokens=res["tokens"], imports_by_shard=shards,
         prefill_tokens=res["prefill_tokens"], stdout=lines[-2:],
         streams_equal_to_cpu=res["tokens"] == cpu["tokens"],
         near_tie_divergences=ties)
    out["examples/serve_partitioned"] = n
    del res, cpu_params, client

    twin = load_twin("quickstart")
    res, lines, n, wall = run_twin(
        twin.main, ["--steps", str(EXAMPLE_QUICKSTART_STEPS)])
    finite = all(np.isfinite(h["loss"]) for h in res["history"]) and all(
        np.isfinite(v) for v in res["losses"].values())
    if not finite or len(res["stream"]) != 8:
        wrong.append(f"quickstart: {res['losses']} {res['stream']}")
    cfg = res["cfg"]
    row = FLASH_BWD_ROWS[fa.bwd_route(torch.bfloat16,
                                      cfg.resolved_head_dim())][0]
    need("quickstart", n, ("flash_attention", row, "paged_attention",
                           "int8_matmul"))
    # the trained weights evaluated and served on the CPU (plain versions):
    # each loss within 2 bf16 ulps, the stream equal but at a near-tie
    cpu_params = to_cpu(res["params"])
    with contextlib.redirect_stdout(None):
        cpu_losses = twin.evaluate(cfg, cpu_params, res["plan"],
                                   device="cpu")
        cpu_stream = twin.serve(cfg, cpu_params, "stablelm-1.6b",
                                device="cpu")
    loss_err = {k: abs(v - cpu_losses[k]) for k, v in res["losses"].items()}
    far = {k: e for k, e in loss_err.items()
           if not e <= 2 * bf16_ulp(cpu_losses[k])}
    if far:
        wrong.append(f"quickstart: eval losses {res['losses']} on the card, "
                     f"{cpu_losses} on the CPU")
    prompt = twin.lm_batch(cfg, twin.SHAPE, 42,
                           device="cpu")["tokens"][0, :8].numpy()
    ties = example_ties("quickstart", cfg, cpu_params, None, [prompt], 8,
                        {0: res["stream"]}, {0: cpu_stream})
    emit("example", card=card, twin="quickstart", wall_s=wall,
         steps=EXAMPLE_QUICKSTART_STEPS, assignments=res["assignments"],
         loss_first=res["history"][0]["loss"],
         loss_last=res["history"][-1]["loss"], eval_losses=res["losses"],
         cpu_eval_losses=cpu_losses, eval_loss_abs_err=loss_err,
         tolerance="2 bf16 ulps of the CPU's loss", stream=res["stream"],
         stream_equal_to_cpu=res["stream"] == cpu_stream,
         near_tie_divergences=ties, reduced=["steps 200 -> 50"])
    out["examples/quickstart"] = n
    del res, cpu_params

    twin = load_twin("train_100m")
    with contextlib.redirect_stdout(None):
        cfg = twin.model_config(640, 12, 50304)
    (ROOT / "build").mkdir(exist_ok=True)
    # the faulted run, its step-FAULT_AT checkpoint kept in memory as it is
    # saved; then the uninterrupted twin runs on from that state (the steps
    # before it are the faulted run's, bit for bit, by determinism)
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import tree_map
    saved = {}

    def keep(self, step, state, *a, **kw):
        if step == twin.FAULT_AT and step not in saved:
            saved[step] = tree_map(torch.clone, state)
        return real_save(self, step, state, *a, **kw)
    d = tempfile.mkdtemp(prefix="example_100m_", dir=ROOT / "build")
    try:
        with patched(CheckpointManager, "save", keep) as real_save:
            (a, hist_a, restarts_a), _, n_a, wall_a = run_twin(
                twin.train, cfg, 512, 8, EXAMPLE_100M_STEPS, d, True, dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    (b, hist_b), _, n_b, wall_b = run_twin(
        uninterrupted_100m, twin, cfg, saved.pop(twin.FAULT_AT),
        EXAMPLE_100M_STEPS, dev)
    equal = all(torch.equal(x, y) for x, y in zip(
        tree_leaves((a.params, a.opt)), tree_leaves((b.params, b.opt))))
    if restarts_a != 1 or not equal or \
            hist_a[twin.FAULT_AT:] != hist_b or \
            int(a.step) != EXAMPLE_100M_STEPS:
        wrong.append(f"train_100m: restarts {restarts_a}, "
                     f"bit-equal {equal}, step {int(a.step)}")
    row = FLASH_BWD_ROWS[fa.bwd_route(torch.bfloat16,
                                      cfg.resolved_head_dim())][0]
    need("train_100m", n_a, ("flash_attention", row))
    emit("example", card=card, twin="train_100m", config=cfg.name,
         params=cfg.param_count(), d_model=cfg.d_model,
         layers=cfg.num_layers, vocab=cfg.vocab_size, seq_len=512, batch=8, steps=EXAMPLE_100M_STEPS, fault_at=25,
         restarts=restarts_a, bit_equal_to_uninterrupted=equal,
         uninterrupted_from_step=twin.FAULT_AT,
         loss=[h["loss"] for h in hist_a[::5]] + [hist_a[-1]["loss"]],
         wall_s_faulted=wall_a, wall_s_uninterrupted=wall_b)
    out["examples/train_100m"] = n_a
    out["examples/train_100m/uninterrupted"] = n_b
    del a, b
    gc.collect()
    torch.cuda.empty_cache()
    if wrong:
        raise AssertionError(f"examples: {wrong}")
    return out


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
            wkv_backward_phase(timer, wk, dev),
            selective_scan_phase(timer, ss, dev, sm_mhz),
            selective_scan_backward_phase(timer, ss, dev, sm_mhz),
            rowwise_quant_phase(timer, rq, dev),
            *flash_backward_phase(timer, fa, dev)]
    sampling_phase(timer, dev)
    del timer
    compression_phase(dev, card)
    tiny_phase(dev)
    tiny_windowed_phase(dev)
    tiny_fleet_phase(dev)
    tiny_coproc_phase(dev)
    tiny_train_phase(dev, fa)
    vision_orbit_phase()
    launches = {row["name"]: {} for row in rows}
    for phase in (lambda: rwkv_full_width_phase(dev, card, wk, im, fa),
                  lambda: jamba_full_width_phase(dev, card),
                  lambda: full_width_phase(dev, card, pa, im, fa)):
        for name, by_plan in phase().items():
            launches[name].update(by_plan)
    gc.collect()                      # the LM phases' weights, in cycles
    torch.cuda.empty_cache()
    for name, n in launch_serve_phase(card, (pa, im, fa)).items():
        launches[name]["qwen3-14b/launch_serve"] = n
    gc.collect()                      # the launcher's weights
    torch.cuda.empty_cache()
    # the two-rank phase's processes start now: their imports and CUDA
    # contexts overlap the one-device training
    ranks = start_train_ranks()
    try:
        one_device = {}
        for plan, by_kernel in train_full_width_phase(dev, card, fa,
                                                      one_device).items():
            for name, n in by_kernel.items():
                launches[name][f"stablelm-1.6b/train/{plan}"] = n
        measured = {"stablelm-1.6b": {k: one_device[k] for k in (
            "step_ms_each", "peak_bytes", "state_bytes")}}
        for plan, by_kernel in train_sharded_phase(dev, card, fa,
                                                   one_device).items():
            for name, n in by_kernel.items():
                launches[name][f"stablelm-1.6b/train_sharded/{plan}"] = n
        by_run, two_rank = train_sharded_2rank_phase(card, *ranks)
        for run, by_kernel in by_run.items():
            for name, n in by_kernel.items():
                launches[name][run] = n
    finally:
        stop_train_ranks(*ranks)
    measured["rwkv6-3b"] = {}
    for plan, by_kernel in rwkv_train_full_width_phase(
            dev, card, wk, measured["rwkv6-3b"]).items():
        for name, n in by_kernel.items():
            launches[name][f"rwkv6-3b/train/{plan}"] = n
    dryrun_phase(card, measured, two_rank)
    for config, by_kernel in launch_train_phase(card).items():
        for name, n in by_kernel.items():
            launches[name][f"{config}/launch_train"] = n
    # the pose phases: cuDNN's deterministic convolutions, so an evaluation
    # repeats bit for bit (TF32 stays off, above)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    tiny_pose_phase(dev)
    timer = Timer(dev)
    launches["int8_matmul"].update(
        ursonet_full_width_phase(dev, card, timer, im))
    del timer
    fleetlint_phase(build)
    for run, by_kernel in examples_phase(dev, card, fa).items():
        for name, n in by_kernel.items():
            if n and name in launches:
                launches[name][run] = n
    for row in rows:
        # each (config, plan) run is a main path, counted from 0 on its
        # own; "launches" is their sum, "launches_by_plan" keeps them apart
        row["launches_by_plan"] = launches[row["name"]]
        row["launches"] = sum(launches[row["name"]].values())
        if row["name"] in ("selective_scan", "rowwise_quant",
                           "flash_attention_bwd",
                           "flash_attention_bwd_mma_sync", "wkv_bwd",
                           "selective_scan_bwd") \
                and not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on the main path")
    emit("total", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["train-rank"]:
        train_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit(main())
