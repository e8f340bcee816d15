#!/usr/bin/env python
"""The dry-run and roofline tables of ``tools/make_experiments.py`` from
the PyTorch port's dry-run artifacts (``repro_torch.launch.dryrun``
writes ``build/dryrun/<tag>.json``, single- and multi-pod alike).

A tag is ``arch__shape__single|multi[__plan][__kv8]``
(``launch/dryrun.py``): the plan column reads its fourth part (bf16 where
there is none), and the roofline table keeps the single-pod (16 x 16)
rows without a variant part.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    python tools/make_experiments_torch.py [--dir build/dryrun] > tables.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def load(dirpath=os.path.join("build", "dryrun")) -> list:
    out = []
    for p in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(p) as f:
            d = json.load(f)
        d["tag"] = os.path.basename(p)[:-5]
        out.append(d)
    return out


def gb(x) -> str:
    return f"{(x or 0) / 1e9:.2f}"


def _bits(d) -> list:
    return d["tag"].split("__")


def dryrun_table(rows) -> None:
    print("| arch | shape | mesh | plan | compile s | args GB/dev | "
          "temp GB/dev | collectives (count) | coll GB/dev |")
    print("|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        bits = _bits(d)
        plan = bits[3] if len(bits) > 3 else "bf16"
        cc = d.get("collective_counts", {})
        ccs = " ".join(f"{k}:{v}" for k, v in sorted(cc.items()))
        # the trace's seconds, as the reference rounds its compile's
        secs = d.get("compile_s")
        print(f"| {d['arch']} | {d['shape']} | {d['mesh']} | {plan} | "
              f"{'-' if secs is None else round(secs, 1)} | "
              f"{gb(d.get('argument_size_in_bytes'))} | "
              f"{gb(d.get('temp_size_in_bytes'))} | {ccs} | "
              f"{gb(d.get('collective_bytes'))} |")


def roofline_table(rows, pods="single") -> None:
    print("| arch | shape | compute ms | memory ms | collective ms | "
          "dominant | model GF | useful | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for d in rows:
        r, bits = d.get("roofline"), _bits(d)
        if not r or bits[2] != pods:
            continue
        if len(bits) > 3:                  # plan variants
            continue
        print(f"| {r['arch']} | {r['shape']} | {r['compute_ms']} | "
              f"{r['memory_ms']} | {r['collective_ms']} | {r['dominant']} | "
              f"{r['model_gflops']} | {r['useful_ratio']} | "
              f"{r['roofline_frac']} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("build", "dryrun"),
                    help="the dry run's JSON artifacts")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print("### Dry-run table\n")
    dryrun_table(rows)
    print("\n### Roofline table (single-pod 16x16, 256 chips)\n")
    roofline_table(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
