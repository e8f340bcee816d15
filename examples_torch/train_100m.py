"""End-to-end training run on the PyTorch port (the twin of
``examples/train_100m.py``): a ~100M-parameter qwen3-family model for a
few hundred steps, with MPAI QAT, checkpointing, and fault-tolerant
restart — the full production loop at local scale.

    PYTHONPATH=src python examples_torch/train_100m.py --steps 300
    # on the CPU (--device cpu) ~100M params x 4k tokens/step is slow;
    # use --dmodel 256 --seq 128 for a quick pass.

Runs on ``--device`` (default ``cuda``; without a card it stops rather
than fall back).  Checkpoints go to a temporary directory that is
removed at the end.
"""
import argparse
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.core import qat
from repro_torch.core.partition import PartitionPlan
from repro_torch.data.pipeline import lm_batch
from repro_torch.launch import require_device
from repro_torch.runtime.fault import FaultInjector, FaultTolerantRunner
from repro_torch.runtime.train_loop import Trainer

FAULT_AT = 25          # the step the fault kills (a checkpoint every 25)


def model_config(dmodel: int, layers: int, vocab: int):
    cfg = get_config("qwen3-14b", smoke=True).with_(
        name="qwen3-100m", num_layers=layers, d_model=dmodel,
        num_heads=dmodel // 64, num_kv_heads=dmodel // 128,
        head_dim=64, d_ff=dmodel * 3, vocab_size=vocab, remat=False)
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model})")
    return cfg


def train(cfg, seq: int, batch: int, steps: int, ckpt_dir: str,
          inject_fault: bool = False, device="cuda"):
    """``steps`` QAT steps through the fault-tolerant runner, a checkpoint
    every 25; with ``inject_fault`` step ``FAULT_AT`` is killed and the
    run restarts from its checkpoint.  Returns (state, history,
    restarts)."""
    shape = ShapeConfig("train", seq, batch, "train")
    tc = TrainConfig(learning_rate=6e-4, warmup_steps=30,
                     total_steps=steps, checkpoint_every=25)
    plan = qat.train_plan(PartitionPlan.mpai(cfg.num_layers))
    trainer = Trainer(cfg, shape, MeshConfig((1, 1), ("data", "model")), tc,
                      plan=plan, device=device)
    state = trainer.init_state()

    ckpt = CheckpointManager(ckpt_dir, keep=3)
    runner = FaultTolerantRunner(trainer, ckpt, max_restarts=3)
    on_step = (FaultInjector(fail_at_steps={FAULT_AT}) if inject_fault
               else None)

    def log_data(s):
        return lm_batch(cfg, shape, s, device=device)

    state, hist = runner.run(state, log_data, steps, on_step=on_step,
                             log_every=max(steps // 15, 1))
    ckpt.wait()
    return state, hist, runner.restarts


def report(state, hist, restarts: int, inject_fault: bool) -> None:
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.3f}  "
              f"gnorm {h['grad_norm']:.2f}")
    if inject_fault:
        print(f"restarts: {restarts} (fault injected at step {FAULT_AT}, "
              f"recovered from checkpoint)")
    print(f"done: {int(state.step)} steps, final loss {hist[-1]['loss']:.3f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dmodel", type=int, default=640)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=50304)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--inject-fault", action="store_true",
                    help="kill step 25 and prove checkpoint/restart works")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(ap, args.device)
    cfg = model_config(args.dmodel, args.layers, args.vocab)
    with tempfile.TemporaryDirectory(prefix="ckpt_100m_") as ckpt_dir:
        state, hist, restarts = train(cfg, args.seq, args.batch, args.steps,
                                      ckpt_dir, args.inject_fault,
                                      args.device)
    report(state, hist, restarts, args.inject_fault)
    return {"state": state, "history": hist, "restarts": restarts}


if __name__ == "__main__":
    main()
