"""Quickstart on the PyTorch port: the MPAI lifecycle on a small LM, end
to end (the twin of ``examples/quickstart.py``).

  1. pick an architecture config (+ reduced size),
  2. let the MPAI scheduler choose a partition (int8 backbone / bf16 head),
  3. partition-aware training (QAT) with the Trainer,
  4. deploy: convert the plan to real-int8 serving and compare the loss
     against the bf16 baseline and a PTQ (no-QAT) deployment,
  5. serve the trained model through the ``repro_torch.serving`` facade:
     FleetSpec -> ServingClient -> streamed tokens.

    PYTHONPATH=src python examples_torch/quickstart.py [--steps 200] \\
        [--device cpu]

Runs on ``--device`` (default ``cuda``; without a card it stops rather
than fall back).  Each step is a function of its own, so a caller can
hand one step other weights (the reference's, through
``repro_torch.bridge``).
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.core import qat
from repro_torch.core.cost_model import transformer_layer_costs
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.scheduler import best_under_accuracy, schedule
from repro_torch.data.pipeline import lm_batch
from repro_torch.launch import require_device
from repro_torch.models import transformer as T
from repro_torch.runtime.train_loop import Trainer
from repro_torch.serving import FleetSpec, PoolSpec

SHAPE = ShapeConfig("quickstart", 64, 8, "train")


def model_config(arch: str):
    """1. reduced config of the chosen architecture family."""
    cfg = get_config(arch, smoke=True).with_(
        num_layers=4, d_model=128, d_ff=256, remat=False)
    print(f"arch={cfg.name}  params~{cfg.param_count()/1e6:.1f}M")
    return cfg


def choose_plan(cfg, shape=SHAPE):
    """2. MPAI scheduler: pick the partition from the cost model."""
    layers = transformer_layer_costs(cfg, shape.seq_len)
    plans = schedule(layers, ["tpu_v5e_int8", "tpu_v5e_bf16"],
                     accuracy_penalty={"tpu_v5e_int8": 0.05})
    chosen = best_under_accuracy(plans, max_penalty=0.045)
    print("scheduler chose:", chosen.assignments,
          f"-> {chosen.latency_s*1e3:.2f} ms model latency")
    return chosen, chosen.to_partition_plan(qat=True)


def train(cfg, plan, steps: int, shape=SHAPE, device="cuda"):
    """3. partition-aware training; returns the trained state."""
    mesh_cfg = MeshConfig((1, 1), ("data", "model"))
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=20, total_steps=steps)
    trainer = Trainer(cfg, shape, mesh_cfg, tc, plan=qat.train_plan(plan),
                      device=device)
    state = trainer.init_state()
    state, hist = trainer.run(
        state, lambda s: lm_batch(cfg, shape, s, device=device), steps,
        log_every=max(steps // 8, 1))
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.3f}")
    return state, hist


def evaluate(cfg, params, plan, shape=SHAPE, device="cuda") -> dict:
    """4. deployment comparison on held-out batches."""
    def eval_loss(plan_):
        tot = 0.0
        for s in range(3):
            b = lm_batch(cfg, shape, 10_000 + s, device=device)
            tot += float(T.loss_fn(params, cfg, b["tokens"], b["labels"],
                                   plan_))
        return tot / 3

    losses = {"bf16": eval_loss(None),
              "mpai": eval_loss(qat.serve_plan(plan)),
              "ptq": eval_loss(PartitionPlan.int8_all(cfg.num_layers))}
    print(f"\neval loss  bf16={losses['bf16']:.4f}  "
          f"MPAI-int8(QAT)={losses['mpai']:.4f}  "
          f"PTQ-int8={losses['ptq']:.4f}")
    print("MPAI deployment keeps the backbone int8 (2x MXU rate, half the "
          "weight bytes) at near-baseline loss; PTQ shows the gap QAT closes.")
    return losses


def serve(cfg, params, arch: str, shape=SHAPE, device="cuda") -> list:
    """5. one front door over the fleet: declare a pool, submit, stream."""
    fleet = FleetSpec(
        pools=[PoolSpec("deploy", ("tpu_v5e_int8", "tpu_v5e_bf16"),
                        backend="engine", capacity=1, max_wait_s=0.0,
                        max_slots=2, prompt_len=8, max_new=8)],
        workload="transformer", arch=arch, seq_len=shape.seq_len)
    client = fleet.build(model=(cfg, params), device=device)
    prompt = lm_batch(cfg, shape, 42, device=device)["tokens"][0, :8]
    handle = client.submit(prompt.cpu().numpy(), slo="offline", max_new=8)
    stream = list(handle.stream())
    print("served through repro.serving:", stream)
    return stream


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(ap, args.device)
    cfg = model_config(args.arch)
    chosen, plan = choose_plan(cfg)
    state, hist = train(cfg, plan, args.steps, device=args.device)
    losses = evaluate(cfg, state.params, plan, device=args.device)
    stream = serve(cfg, state.params, args.arch, device=args.device)
    return {"assignments": chosen.assignments,
            "latency_s": chosen.latency_s, "history": hist,
            "losses": losses, "stream": stream, "cfg": cfg, "plan": plan,
            "params": state.params}


if __name__ == "__main__":
    main()
