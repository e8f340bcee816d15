#!/usr/bin/env python3
"""Time the causal flash-attention and int8 GEMM kernels at the shapes the
serving paths give them, for one checkout of the port.

    python3 scripts/kernel_bench.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two versions of the kernels can be held side by side
on one card: run it once per checkout, in turns (A, B, B, A), on the same
card.  Each kernel builds into its own checkout's ``build/``.  Prints
one JSON line: the card's name and power limit, and per shape the median
device time of the wrapper over CUDA events, twice: ``ms`` with the L2
scrubbed by writing 128 MB before each launch, as ``chip_smoke.py`` times
it (the launch then also pays for writing back up to the 50 MB of dirty
lines it evicts), and ``ms_clean_l2`` with the L2 scrubbed by reading
128 MB (cold and clean).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# (B, S, gp) with KVp 8, hd 128: the Qwen3-14B admission round, Jamba's
# attention prefill window, a 2048-token Qwen3 prefill
FLASH_SHAPES = [(8, 32, 5), (8, 128, 4), (1, 2048, 5)]
# (M, K, N): a Qwen3-14B layer at decode (M 8) and at the admission bucket
# (M 256); RWKV-6 3B's and Jamba's widths at a window prefill (M 1024)
QWEN_KN = [(5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120)]
INT8_SHAPES = ([(8, k, n) for k, n in QWEN_KN]
               + [(256, k, n) for k, n in QWEN_KN]
               + [(1024, k, n) for k, n in [(2560, 2560), (2560, 8960),
                                            (8960, 2560), (4096, 16384),
                                            (8192, 4096)]])


def median_ms(fn, flush, reps: int = 15) -> float:
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    scrub = torch.zeros(32 * 2 ** 20, dtype=torch.float32, device=dev)
    flushes = {"ms": scrub.zero_, "ms_clean_l2": lambda: scrub.sum()}
    g = torch.Generator(device=dev).manual_seed(0)
    flash, int8 = [], []
    for b, s, gp in FLASH_SHAPES:
        q = torch.randn((b, s, 8, gp, 128), generator=g,
                        device=dev).bfloat16()
        k = torch.randn((b, s, 8, 128), generator=g, device=dev).bfloat16()
        v = torch.randn((b, s, 8, 128), generator=g, device=dev).bfloat16()
        flash.append({"B": b, "S": s, "gp": gp, **{
            key: median_ms(lambda: fa.flash_attention(q, k, v), flush)
            for key, flush in flushes.items()}})
    for m, k, n in INT8_SHAPES:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        int8.append({"M": m, "K": k, "N": n, **{
            key: median_ms(lambda: im.int8_matmul(x, w), flush)
            for key, flush in flushes.items()}})
    print(json.dumps({"label": args.label, "src": args.src, "card": card,
                      "flash_attention": flash, "int8_matmul": int8}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
