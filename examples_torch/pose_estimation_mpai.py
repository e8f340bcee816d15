"""The paper's own workload on the PyTorch port, end to end: UrsoNet
satellite pose estimation with the MPAI partition (Table I reproduction at
example scale; the twin of ``examples/pose_estimation_mpai.py``).

Trains the four software conditions on the synthetic soyuz-like task and
prints the Table-I-shaped comparison: latency from the calibrated cost
model (the paper's processors, not the card this runs on), accuracy
measured.

    PYTHONPATH=src python examples_torch/pose_estimation_mpai.py \\
        [--steps 400] [--batch 32] [--device cpu]

Training and evaluation run on ``--device`` (default ``cuda``; without a
card the example stops rather than fall back).  Under ``int8_ptq`` and
``int8_qat`` the served heads' three FC products run through the int8
GEMM kernel on the card.
"""
import argparse
import dataclasses

from repro_torch.core.accelerators import PROFILES
from repro_torch.core.cost_model import layer_costs_from_convspecs, segment_cost
from repro_torch.core.scheduler import mpai_reference_plan
from repro_torch.launch import require_device
from repro_torch.models.cnn import UrsoNetConfig, ursonet_table1_layers
from repro_torch.pose import run_condition

# the paper's Table I rows, processor: (inference_ms, LOCE m, ORIE deg)
# (copied from benchmarks/table1_ursonet.py:23-30)
PAPER_ROWS = {
    "cortex_a53": (9890, 0.68, 7.28),
    "cortex_a53_fp16": (4210, 0.87, 8.09),
    "myriadx_vpu": (246, 0.69, 8.71),
    "edge_tpu": (149, 0.66, 7.60),
    "mpsoc_dpu": (53, 0.96, 9.29),
    "dpu+vpu": (79, 0.68, 7.32),
}
CONDITIONS = ("fp32", "int8_ptq", "int8_qat", "mpai")


def _edge_tpu_effective(layers):
    """The Edge TPU's profile for ``layers`` (copied from
    benchmarks/fig2_throughput.py:29-37): ~8 MB of on-chip SRAM, so models
    whose int8 weights fit stream at full rate, and larger ones re-fetch
    their weights over the slow host link per inference."""
    prof = PROFILES["edge_tpu"]
    wbytes = sum(l.weight_elems for l in layers)          # int8 weights
    if wbytes <= 7.5e6:
        return dataclasses.replace(prof, mem_bw=30e9)     # SRAM-resident
    return dataclasses.replace(prof, weight_bw=0.3e9)     # USB/DDR refetch


def latency_rows():
    """The cost model's latency of full-size UrsoNet on each of the
    paper's processors and on the MPAI DPU+VPU split, beside the paper's
    (copied from benchmarks/table1_ursonet.py:33-48)."""
    layers = layer_costs_from_convspecs(ursonet_table1_layers())
    rows = []
    for dev in ("cortex_a53", "cortex_a53_fp16", "myriadx_vpu", "edge_tpu",
                "mpsoc_dpu"):
        prof = (_edge_tpu_effective(layers) if dev == "edge_tpu"
                else PROFILES[dev])
        c = segment_cost(layers, prof)
        rows.append({"processor": dev, "model_ms": c.latency_s * 1e3,
                     "paper_ms": PAPER_ROWS[dev][0]})
    mp = mpai_reference_plan(layers)
    rows.append({"processor": "dpu+vpu", "model_ms": mp.latency_s * 1e3,
                 "paper_ms": PAPER_ROWS["dpu+vpu"][0]})
    return rows


def model_config() -> UrsoNetConfig:
    return UrsoNetConfig(name="example", image_hw=(96, 128),
                         widths=(16, 32, 64), blocks_per_stage=1, fc_dim=128)


def print_latency():
    print("=== latency (cost model, full-size UrsoNet @1280x960) ===")
    print(f"{'processor':18s} {'model ms':>9s} {'paper ms':>9s}")
    rows = latency_rows()
    for r in rows:
        print(f"{r['processor']:18s} {r['model_ms']:9.0f} {r['paper_ms']:9.0f}")
    return rows


def accuracy(steps: int, batch: int, device="cuda"):
    """Train and evaluate each condition; one line each."""
    print("\n=== accuracy (measured, synthetic pose task) ===")
    cfg = model_config()
    rows = []
    for cond in CONDITIONS:
        r = run_condition(cond, cfg, steps=steps, batch=batch, device=device)
        rows.append(r)
        print(f"{cond:10s} LOCE={r['loce']:.3f} m  ORIE={r['orie']:.2f} deg  "
              f"(train loss {r['final_train_loss']:.3f})")
    return rows


def print_deltas(rows):
    by = {r["condition"]: r for r in rows}
    print("\nTable-I delta structure:")
    print(f"  PTQ degrades vs fp32:   dORIE="
          f"{by['int8_ptq']['orie'] - by['fp32']['orie']:+.2f} deg")
    print(f"  MPAI recovers (QAT+bf16 head): dORIE="
          f"{by['mpai']['orie'] - by['fp32']['orie']:+.2f} deg")
    print("  (paper: DPU-alone ORIE 9.29 vs baseline 7.28; DPU+VPU 7.32)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(ap, args.device)
    latency = print_latency()
    rows = accuracy(args.steps, args.batch, args.device)
    print_deltas(rows)
    return {"latency": latency, "accuracy": rows}


if __name__ == "__main__":
    main()
