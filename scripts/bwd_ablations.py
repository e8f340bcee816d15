#!/usr/bin/env python3
"""Where the time of the two backward kernels goes: each part removed in
turn, or a layout changed, by a text edit of a copy of the source, and every
variant timed on the same inputs on one card.

    python3 scripts/bwd_ablations.py

The wkv backward (``csrc/wkv_bwd.cu``) is timed at the RWKV-6 3B training
layer (B 4, S 4096, H 40, N 64), the selective-scan backward
(``csrc/selective_scan_bwd.cu``) at Jamba's layer (D 8192, N 16) at B 1, S
2048 and B 8, S 128, with the sequence split on and off.  A variant that
removes work computes wrong gradients: only its time is read, the time
that part costs being the difference from ``base``.  Each variant builds
with ``kernels/build.py``'s flags into ``build/bwd_ablations/``; its C entry
is called as the wrappers call theirs.  Device ms are medians of 10 launches
by CUDA events.  Prints one JSON line with the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels import wkv as wk  # noqa: E402

OUT = ROOT / "build" / "bwd_ablations"


def edit(text: str, pairs) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"bwd_ablations: the source no longer has "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def variants():
    w = (build.CSRC / "wkv_bwd.cu").read_text()
    s = (build.CSRC / "selective_scan_bwd.cu").read_text()
    carry_w = "    wkv_bwd_carry_kernel<N><<<"
    walk_w = "    carried = xs;\n  }"
    epi_a = w.index("    for (int e = tid; e < sl * MC; e += THREADS) {")
    epi_b = w.index("    cluster_wait();                      // every CTA's")
    epi_c = w.index("#pragma unroll\n    for (int kk = 0; kk < PPT; ++kk) {")
    epi_d = w.index("    par ^= 1;\n  }\n  cluster_arrive();")
    wv = {
        "base": w,
        "carry_only": edit(w, [(walk_w, walk_w + "\n  return 0;")]),
        "walk_only": edit(w, [(carry_w, "    if (0)" + carry_w[3:])]),
        "no_staging": edit(w, [
            ("          cp_async16(st + (a * T + c) * N + 4 * y, src + o"
             " + 4 * y);", ""),
            ("          cp_async16(st + 3 * T * N + (a * T + c) * MC + 4 * y,\n"
             "                     (a ? dy : v) + o + rank * MC + 4 * y);", "")]),
        "no_epilogue": (w[:epi_a] + w[epi_b:epi_c] + w[epi_d:]),
        "no_cluster_barriers": edit(w, [
            ("    cluster_arrive();                    // partials out", "//"),
            ("    cluster_wait();                      // every CTA's", "//"),
            ("  cluster_arrive();        // no CTA leaves", "//"),
            ("  cluster_wait();\n  float* dus", "  float* dus"),
            ("const float* xr = cluster.map_shared_rank(xb, q);",
             "const float* xr = xb;"),
            ("cluster.map_shared_rank(dpart, q)[par * T + c]",
             "dpart[par * T + c]")]),
        "no_dv_scatter": edit(w, [
            ("Scatter<COLS, 0, W::LOGR>::run(pv, lane, G, idx, mask);", "")]),
        "no_replays": edit(w, [
            ("if (c + 1 < T && (FULL || c + 1 < sl)) {", "if (false) {"),
            ("    if (p < nsub - 1) {                // pass 1: a whole sub-"
             "chunk forward", "    if (p < nsub - 1) continue;\n    if (false) {")]),
        "ctas_of_16_columns": edit(w, [
            ("static constexpr int MC = N >= 64 ? 32 : (N >= 16 ? 16 : N);",
             "static constexpr int MC = N >= 16 ? 16 : N;")]),
    }
    cnpt = "  static constexpr int CNPT = 2; "
    carry_s = ("    if (e != cudaSuccess) return (int)e;\n"
               "  } else if (split) {")
    sv = {
        "base": s,
        "carry_only": edit(s, [
            (carry_s, "    return (int)e;\n  } else if (split) {")]),
        "walk_only": edit(s, [
            ("    selective_scan_bwd_carry_kernel<N>\n        <<<",
             "    if (0) selective_scan_bwd_carry_kernel<N>\n        <<<")]),
        "no_staging": edit(s, [
            ("      if (4 * j < cnt) cp_async16(out + 4 * j, src + 4 * j);", ""),
            ("      cp_async16(rdst + (a * ST + c) * N + 4 * j,\n"
             "                 rows[a] + (row0 + c) * N + 4 * j);", "      ;")]),
        "no_db_dc_scatter": edit(s, [
            ("Scatter<VB, 0, Tl::LOGR, 1>::run(pb, lane, L, ib);", "")]),
        "carry_1_state_a_thread": edit(s, [
            (cnpt, "  static constexpr int CNPT = 1;")]),
        "carry_4_states_a_thread": edit(s, [
            (cnpt, "  static constexpr int CNPT = N >= 16 ? 4 : 2;")]),
    }
    return wv, sv


def compile_all(wv, sv):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kind, group in (("wkv", wv), ("scan", sv)):
        for name, text in group.items():
            src = OUT / f"{kind}_{name}.cu"
            src.write_text(text)
            procs[(kind, name)] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o",
                 str(src.with_suffix(".so")), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bwd_ablations: {key} did not build:\n{out}")


def entry(kind: str, name: str, symbol: str, argtypes):
    fn = getattr(ctypes.CDLL(str(OUT / f"{kind}_{name}.so")), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def median_ms(call, reps: int = 10) -> float:
    call()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_ablations: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wv, sv = variants()
    compile_all(wv, sv)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"card": card, "wkv_bwd": {}, "selective_scan_bwd": {}}

    b, s, h, n = 4, 4096, 40, 64
    mk = lambda: torch.randn((b, s, h, n), generator=g, device=dev)
    r, k, v, dy = mk(), mk(), mk(), mk()
    w = torch.exp(-torch.exp(mk() - 1))
    u = torch.randn((h, n), generator=g, device=dev)
    _, _, ckpt = wk._launch(r, k, v, w, u, checkpoints=True)
    outs = [torch.empty_like(r) for _ in range(4)]
    xs = torch.empty_like(ckpt)
    du = torch.empty((b, h, ckpt.shape[2], n), device=dev)
    for name in wv:
        fn = entry("wkv", name, "wkv_bwd_f32", wk._BWD_ARGTYPES)
        call = lambda: build.check(fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dy.data_ptr(), ckpt.data_ptr(), 0, xs.data_ptr(),
            *[o.data_ptr() for o in outs], du.data_ptr(), b, s, h, n,
            stream), name)
        result["wkv_bwd"][name] = median_ms(call)
    del r, k, v, w, dy, ckpt, outs, xs, du
    torch.cuda.empty_cache()

    dim, n = 8192, 16
    for b, s in ((1, 2048), (8, 128)):
        x = torch.randn((b, s, dim), generator=g, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, dim), generator=g, device=dev) - 3)
        bm = torch.randn((b, s, n), generator=g, device=dev)
        cm = torch.randn((b, s, n), generator=g, device=dev)
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(dim, n).contiguous()
        d = torch.ones(dim, device=dev)
        dyy = torch.randn_like(x)
        _, _, ckpt = ss._launch(x, dt, bm, cm, a, d, checkpoints=True)
        chunks = ckpt.shape[2]
        dx, ddt = torch.empty_like(x), torch.empty_like(x)
        dbp = torch.empty((ss.bwd_blocks(dim, n), b, s, n), device=dev)
        dcp = torch.empty_like(dbp)
        dap = torch.empty((chunks, b, dim, n), device=dev)
        ddp = torch.empty((chunks, b, dim), device=dev)
        xs = torch.empty_like(ckpt)
        rows = {}
        for split in (1, 0):
            for name in sv:
                if not split and ("carry" in name or name == "walk_only"):
                    continue               # no carry runs without the split
                fn = entry("scan", name, "selective_scan_bwd_f32",
                           ss._BWD_ARGTYPES)
                call = lambda: build.check(fn(
                    x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                    a.data_ptr(), d.data_ptr(), dyy.data_ptr(),
                    ckpt.data_ptr(), 0, xs.data_ptr(), dx.data_ptr(),
                    ddt.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
                    dap.data_ptr(), ddp.data_ptr(), b, s, dim, n, split,
                    stream), name)
                rows[f"{name}, split {bool(split)}"] = median_ms(call)
        result["selective_scan_bwd"][f"B {b}, S {s}"] = rows
        del x, dt, bm, cm, dyy, ckpt, dx, ddt, dbp, dcp, dap, ddp, xs
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
