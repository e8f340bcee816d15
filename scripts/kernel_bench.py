#!/usr/bin/env python3
"""Time the paged decode attention, wkv (forward and backward), causal
flash-attention (forward and backward), int8 GEMM, selective-scan (forward
and backward) and row-wise quant kernels, and the int8 KV cache write, at
the shapes the serving and training paths give them, for one checkout of
the port.

    python3 scripts/kernel_bench.py [--src DIR] [--label NAME] [--only K,...]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two versions of the kernels can be held side by side
on one card: run it once per checkout, in turns (A, B, B, A), on the same
card.  Each kernel builds into its own checkout's ``build/``.  Prints
one JSON line: the card's name and power limit, and per shape the median
device time of the wrapper over CUDA events, twice, with ``chip_smoke.py``'s
timer: ``ms`` with the L2 scrubbed by writing 128 MB before each launch
(the launch then also pays for writing back up to the 50 MB of dirty lines
it evicts), and ``ms_clean_l2`` with the L2 scrubbed by reading 128 MB
(cold and clean); paged attention, wkv, the flash-attention forward, the
selective scan, the row-wise quant and the KV write also get
``device_ms``, one wrapper call captured in a CUDA graph and replayed
after the write scrub (the kernel without the wrapper's host time); so
does the flash-attention backward
(``flash_attention_bwd`` itself, not autograd), at the bf16 shapes of
``chip_smoke.FLASH_BWD_CASES``, with the route where the checkout names
one; so do the wkv backward (``wkv_bwd`` at ``chip_smoke.RWKV_TRAIN_SHAPE``
with 40 heads of 64, and at B 2, S 37 with the final state's gradient) and
the selective-scan backward (``selective_scan_bwd`` at
``chip_smoke.SCAN_SHAPES``, the ragged one with the final state's
gradient), with their launch plans where the checkout has them, and, where
the checkout's scan backward has a plan (``bwd_plan``) and more than one
chunk, also timed with the plan's sequence split turned the other way
(``"split_flipped"``).  The flash-attention forward also gets its plain
version's ``plain_ms`` (at the training layer, ~8.6 GB of f32 scores).
``--only`` names the result keys to time (default: all).  The int8 KV
write is the fused ``rowwise_quant_into`` where the checkout has it, else
the checkout's own sequence of two row-wise quant launches and four slot
copies (``"fused": false``), so that two checkouts compare like with
like.  The inputs are ``chip_smoke.py``'s.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (FLASH_BWD_CASES, KV_WRITE_CASES,  # noqa: E402
                        PAGED_CASES, QUANT_SHAPES, RWKV_TRAIN_SHAPE,
                        SCAN_SHAPES, Timer, kv_write_case, kv_write_sequence,
                        paged_case, quant_rows, scan_case)

# (B, S, KVp, gp, hd): the Qwen3-14B admission round, Jamba's attention
# prefill window, a 2048-token Qwen3 prefill (KVp 8, hd 128), and a
# StableLM-2 1.6B training layer (B 4, S 4096, 32 heads of 64)
FLASH_SHAPES = [(8, 32, 8, 5, 128), (8, 128, 8, 4, 128), (1, 2048, 8, 5, 128),
                (4, 4096, 32, 1, 64)]
# (M, K, N): a Qwen3-14B layer at decode (M 8) and at the admission bucket
# (M 256); RWKV-6 3B's and Jamba's widths at a window prefill (M 1024)
QWEN_KN = [(5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120)]
# wkv (H 40, N 64): the RWKV-6 3B prefill window, one 2048-token prompt
WKV_SHAPES = [(8, 128), (1, 2048)]
INT8_SHAPES = ([(8, k, n) for k, n in QWEN_KN]
               + [(256, k, n) for k, n in QWEN_KN]
               + [(1024, k, n) for k, n in [(2560, 2560), (2560, 8960),
                                            (8960, 2560), (4096, 16384),
                                            (8192, 4096)]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--only", default="",
                    help="comma-separated result keys to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant as rq
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import wkv as wk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timers = {"ms": Timer(dev), "ms_clean_l2": Timer(dev, clean=True)}
    g = torch.Generator(device=dev).manual_seed(0)

    def times(call, device_ms: bool = False) -> dict:
        row = {key: t.ms(call) for key, t in timers.items()}
        if device_ms:
            row["device_ms"] = timers["ms"].device_ms(call)
        return row

    result = {"paged_attention": [], "wkv": [], "wkv_bwd": [],
              "flash_attention": [], "flash_attention_bwd": [],
              "int8_matmul": [], "selective_scan": [],
              "selective_scan_bwd": [], "rowwise_quant": [],
              "int8_kv_write": []}
    if args.only:
        result = {k: [] for k in args.only.split(",")}
    want = lambda key: key in result
    for seed, (label, lengths, num_blocks) in enumerate(
            PAGED_CASES if want("paged_attention") else ()):
        a = paged_case(dev, lengths, seed, num_blocks)
        row = {"shape": label,
               **times(lambda: pa.paged_attention(*a), device_ms=True)}
        if hasattr(pa, "plan"):
            row["plan"] = pa.plan(len(lengths), 8, a[3].shape[1], sms)
        result["paged_attention"].append(row)
        del a
    for b, s in WKV_SHAPES if want("wkv") else ():
        mk = lambda: torch.randn((b, s, 40, 64), generator=g, device=dev)
        a = (mk(), mk(), mk(), torch.exp(-torch.exp(mk() - 1)),
             torch.randn((40, 64), generator=g, device=dev))
        result["wkv"].append({"B": b, "S": s, "H": 40, "N": 64,
                              **times(lambda: wk.wkv(*a), device_ms=True)})
    seq, batch = RWKV_TRAIN_SHAPE
    for b, s, with_ds in (((batch, seq, False), (2, 37, True))
                          if want("wkv_bwd") else ()):
        mk = lambda: torch.randn((b, s, 40, 64), generator=g, device=dev)
        r, k, v, dy = mk(), mk(), mk(), mk()
        w = torch.exp(-torch.exp(mk() - 1))
        u = torch.randn((40, 64), generator=g, device=dev)
        ds = (torch.randn((b, 40, 64, 64), generator=g, device=dev)
              if with_ds else None)
        _, _, ckpt = wk._launch(r, k, v, w, u, checkpoints=True)
        row = {"B": b, "S": s, "H": 40, "N": 64, "ds_fin": with_ds,
               **times(lambda: wk.wkv_bwd(r, k, v, w, u, ckpt, dy, ds),
                       device_ms=True)}
        if hasattr(wk, "bwd_plan"):
            row["plan"] = wk.bwd_plan(s, 64)._asdict()
        if hasattr(wk, "bwd_clusters"):
            row["resident_clusters"] = wk.bwd_clusters(b, s, 40, 64)
        result["wkv_bwd"].append(row)
        del r, k, v, w, u, dy, ds, ckpt
        torch.cuda.empty_cache()
    for b, s, kvp, gp, hd in FLASH_SHAPES if want("flash_attention") else ():
        mk = lambda *shape: torch.randn(shape, generator=g,
                                        device=dev).bfloat16()
        q, k, v = mk(b, s, kvp, gp, hd), mk(b, s, kvp, hd), mk(b, s, kvp, hd)
        row = {"B": b, "S": s, "KVp": kvp, "gp": gp, "hd": hd,
               **times(lambda: fa.flash_attention(q, k, v), device_ms=True)}
        if hasattr(fa, "flash_attention_plain"):
            row["plain_ms"] = timers["ms"].ms(
                lambda: fa.flash_attention_plain(q, k, v))
        result["flash_attention"].append(row)
        del q, k, v
        torch.cuda.empty_cache()
    for b, s, kvp, gp, hd, dtype in FLASH_BWD_CASES:
        if dtype != "bfloat16" or not want("flash_attention_bwd"):
            continue
        mk = lambda *shape: torch.randn(shape, generator=g,
                                        device=dev).bfloat16()
        q, do = mk(b, s, kvp, gp, hd), mk(b, s, kvp, gp, hd)
        k, v = mk(b, s, kvp, hd), mk(b, s, kvp, hd)
        out, lse = fa._forward(q, k, v, True)
        row = {"B": b, "S": s, "KVp": kvp, "gp": gp, "hd": hd,
               **times(lambda: fa.flash_attention_bwd(do, q, k, v, out, lse),
                       device_ms=True)}
        if hasattr(fa, "bwd_route"):
            row["route"] = fa.bwd_route(torch.bfloat16, hd)
        result["flash_attention_bwd"].append(row)
        del q, do, k, v, out, lse
        torch.cuda.empty_cache()
    for m, k, n in INT8_SHAPES if want("int8_matmul") else ():
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        result["int8_matmul"].append(
            {"M": m, "K": k, "N": n, **times(lambda: im.int8_matmul(x, w))})
    for b, s in SCAN_SHAPES if want("selective_scan") else ():
        a = scan_case(dev, b, s, g)
        row = {"B": b, "S": s, "D": 8192, "N": 16,
               **times(lambda: ss.selective_scan(*a), device_ms=True)}
        if hasattr(ss, "plan"):
            row["lanes"] = ss.plan(b, 8192, 16, sms)
        result["selective_scan"].append(row)
        del a
    for b, s in SCAN_SHAPES if want("selective_scan_bwd") else ():
        a = scan_case(dev, b, s, g)
        dy = torch.randn((b, s, 8192), generator=g, device=dev)
        dh = (torch.randn((b, 8192, 16), generator=g, device=dev)
              if (b, s) == (3, 37) else None)
        _, _, ckpt = ss._launch(*a, checkpoints=True)
        row = {"B": b, "S": s, "D": 8192, "N": 16, "dh_fin": dh is not None,
               **times(lambda: ss.selective_scan_bwd(*a, ckpt, dy, dh),
                       device_ms=True)}
        if hasattr(ss, "bwd_plan"):
            plan = ss.bwd_plan(b, s, 8192, 16, sms)
            row["plan"] = plan._asdict()
            if plan.chunks > 1:            # the plan's choice turned over
                chosen = ss.bwd_plan
                ss.bwd_plan = lambda *shape: chosen(*shape)._replace(
                    split=not plan.split)
                try:
                    row["split_flipped"] = times(
                        lambda: ss.selective_scan_bwd(*a, ckpt, dy, dh),
                        device_ms=True)
                finally:
                    ss.bwd_plan = chosen
        result["selective_scan_bwd"].append(row)
        del a, dy, dh, ckpt
    for m, k in QUANT_SHAPES if want("rowwise_quant") else ():
        x = quant_rows(dev, m, k, torch.bfloat16, g)
        result["rowwise_quant"].append(
            {"M": m, "K": k, "dtype": "bfloat16",
             **times(lambda: rq.rowwise_quant(x), device_ms=True)})
    fused = hasattr(rq, "rowwise_quant_into")
    for seed, (label, s, t, pos, ring) in enumerate(
            KV_WRITE_CASES if want("int8_kv_write") else ()):
        k, v, bufs, _, slot = kv_write_case(dev, s, t, pos, ring, seed)
        call = ((lambda: rq.rowwise_quant_into(k, v, *bufs, slot)) if fused
                else (lambda: kv_write_sequence(rq, k, v, bufs, slot)))
        result["int8_kv_write"].append(
            {"case": label, "S": s, "T": t, "fused": fused,
             **times(call, device_ms=True)})
    print(json.dumps({"label": args.label, "src": args.src, "card": card,
                      **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
