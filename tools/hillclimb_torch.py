#!/usr/bin/env python
"""The hillclimb tool for the PyTorch port: the named (cell x variant)
experiments of ``tools/hillclimb.py``, traced by the port's dry run, each
writing ``build/perf/<tag>.json``.

Each experiment is the reference's, name for name and in its order, with
the same arch, shape, pod count, plan and config overrides: the remat
group and ``grad_accum`` of Llama-3 405B's train cell, tensor-parallel
against ``sharding_mode="fsdp"`` training of StableLM-2 and Qwen3, bf16
against ``"mpai"`` Qwen3 serving.  ``run`` traces the cell as rank 0 of a
fake world of the production mesh (``repro_torch.launch.dryrun.
trace_cell`` under ``fake_world``, no device), then ``roofline_row``.

The artifact has the reference's keys (the dry-run stats, ``roofline``,
``variant``, ``overrides``, ``plan``, ``wall_s``) but its probe keys: the
reference's ``probe_costs`` and ``scanned_raw`` undo XLA's counting of a
scanned layer once, and the port's trace unrolls every layer, so its
totals are the raw counts.  They are on the CPU: Llama-3 405B's train
cell takes minutes to trace.

    PYTHONPATH=src python tools/hillclimb_torch.py <experiment> [...]
    PYTHONPATH=src python tools/hillclimb_torch.py --list
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

from repro_torch.configs import SHAPES, get_config          # noqa: E402
from repro_torch.launch.dryrun import (fake_world, roofline_row,  # noqa: E402
                                       trace_cell)
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     production_mesh_config)

OUT_DIR = os.path.join("build", "perf")
# the dry run's keys that the reference's probes fill, which have no
# counterpart here
PROBE_KEYS = ("scanned_raw", "probe_s")


def run(tag, arch, shape_name, *, multi_pod=False, plan="bf16", tc=None,
        smoke=False, mesh_cfg=None, out_dir=OUT_DIR, **overrides):
    """Trace ``arch`` (its smoke config with ``smoke``) with ``overrides``
    at ``shape_name`` under ``plan`` as rank 0 of a fake world of the
    production mesh (``mesh_cfg`` instead, where given), write
    ``out_dir/<tag>.json`` and print the one-line summary.  Returns the
    stats."""
    production = mesh_cfg is None
    mesh_cfg = mesh_cfg or production_mesh_config(multi_pod=multi_pod)
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = SHAPES[shape_name]
    t0 = time.time()
    with fake_world(mesh_cfg.num_devices):
        mesh = make_production_mesh(multi_pod=multi_pod) if production \
            else None
        stats = trace_cell(cfg, shape, mesh_cfg, plan, tc=tc,
                           device_mesh=mesh)
    stats.pop("tally")
    for k in PROBE_KEYS:
        stats.pop(k)
    stats["roofline"] = roofline_row(cfg, shape, mesh_cfg, stats)
    stats["variant"] = tag
    stats["overrides"] = {k: str(v) for k, v in overrides.items()}
    stats["plan"] = plan
    stats["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(stats, f, indent=1)
    r = stats["roofline"]
    print(f"{tag}: c/m/x = {r['compute_ms']}/{r['memory_ms']}/"
          f"{r['collective_ms']} ms dominant={r['dominant']} "
          f"frac={r['roofline_frac']} useful={r['useful_ratio']} "
          f"temp/dev={(stats.get('temp_size_in_bytes') or 0) / 1e9:.1f}GB",
          flush=True)
    return stats


EXPERIMENTS = {
    # cell A: llama3-405b train_4k (worst roofline fraction; memory/compute)
    "llama_base": lambda: run("llama_base", "llama3-405b", "train_4k",
                              multi_pod=True),
    "llama_flat_remat": lambda: run("llama_flat_remat", "llama3-405b",
                                    "train_4k", multi_pod=True,
                                    remat_group=0),
    "llama_g18": lambda: run("llama_g18", "llama3-405b", "train_4k",
                             multi_pod=True, remat_group=18),
    "llama_accum16": lambda: run("llama_accum16", "llama3-405b", "train_4k",
                                 multi_pod=True, grad_accum=16),
    "llama_accum4": lambda: run("llama_accum4", "llama3-405b", "train_4k",
                                multi_pod=True, grad_accum=4),
    # cell B: most collective-bound train cell — TP vs pure-FSDP sharding
    "stablelm_base": lambda: run("stablelm_base", "stablelm-1.6b",
                                 "train_4k"),
    "stablelm_fsdp": lambda: run("stablelm_fsdp", "stablelm-1.6b",
                                 "train_4k", sharding_mode="fsdp"),
    "qwen3_train_base": lambda: run("qwen3_train_base", "qwen3-14b",
                                    "train_4k"),
    "qwen3_train_fsdp": lambda: run("qwen3_train_fsdp", "qwen3-14b",
                                    "train_4k", sharding_mode="fsdp"),
    # cell C: the paper's technique on serving — bf16 vs MPAI int8 deploy
    "qwen3_decode_bf16": lambda: run("qwen3_decode_bf16", "qwen3-14b",
                                     "decode_32k"),
    "qwen3_decode_mpai": lambda: run("qwen3_decode_mpai", "qwen3-14b",
                                     "decode_32k", plan="mpai"),
    "qwen3_prefill_bf16": lambda: run("qwen3_prefill_bf16", "qwen3-14b",
                                      "prefill_32k"),
    "qwen3_prefill_mpai": lambda: run("qwen3_prefill_mpai", "qwen3-14b",
                                      "prefill_32k", plan="mpai"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list or not args.names:
        print("\n".join(EXPERIMENTS))
        return 0
    for name in args.names:
        EXPERIMENTS[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
