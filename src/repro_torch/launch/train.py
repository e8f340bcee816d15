"""Training launcher (the port of ``repro.launch.train``), on the card
unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --shape 4096x4 --steps 4 [--plan mpai]
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium \\
        --smoke --steps 2 --device cpu

    python -m torch.distributed.run --nproc_per_node 2 -m \
        repro_torch.launch.train --arch stablelm-1.6b --smoke --steps 2 \
        --device cpu

``--shape`` is a name of ``configs.SHAPES`` (``train_4k``: 4096 tokens x
256 sequences) or ``SEQxBATCH``; ``--smoke`` cuts it to at most 128 x 8
and takes the arch's smoke config.  ``--mesh local`` is a (world, 1) data
x model mesh over the process group ``torchrun`` sets up (gloo on the CPU,
NCCL on cards, a card a rank), or one device when none runs;
``--mesh single_pod|multi_pod`` takes the reference's production meshes
and needs their 256 / 512 ranks.  Checkpoints go to ``--ckpt-dir``
(default: a new directory under ``build/`` of the checkout, rank 0's) every
``--ckpt-every`` steps, through ``FaultTolerantRunner``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import production_mesh_config
from repro_torch.core import qat
from repro_torch.core.partition import PartitionPlan
from repro_torch.data.pipeline import lm_batch
from repro_torch.launch import require_device
from repro_torch.models.frontends import synthetic_frontend_embeds
from repro_torch.runtime.fault import FaultTolerantRunner
from repro_torch.runtime.train_loop import Trainer

BUILD = Path(__file__).resolve().parents[3] / "build"


def join_world(device: str) -> bool:
    """Join the process group ``torchrun`` describes in the environment
    (gloo for the CPU, NCCL for cards), if it does and none is joined yet;
    True when this call joined it."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group("nccl" if device.startswith("cuda") else "gloo")
    return True


def build(args, world: int = 1):
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.shape in SHAPES:
        shape = SHAPES[args.shape]
    else:
        seq, batch = map(int, args.shape.split("x"))
        shape = ShapeConfig("custom", seq, batch, "train")
    if args.smoke:
        shape = ShapeConfig("smoke", min(shape.seq_len, 128),
                            min(shape.global_batch, 8), "train")
    if args.mesh == "local":
        mesh_cfg = MeshConfig((world, 1), ("data", "model"))
    else:
        mesh_cfg = production_mesh_config(multi_pod=args.mesh == "multi_pod")
    plan = None
    if args.plan == "mpai":
        plan = qat.train_plan(PartitionPlan.mpai(cfg.num_layers))
    tc = TrainConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every)
    return cfg, shape, mesh_cfg, plan, tc


def main(argv=None) -> dict:
    """Train ``--steps`` steps and print one line a logged step; returns
    the config name, the shape and the history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--plan", default="bf16", choices=["bf16", "mpai"])
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single_pod", "multi_pod"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (the card unless 'cpu')")
    args = ap.parse_args(argv)
    require_device(ap, args.device)

    import torch
    import torch.distributed as dist
    joined = join_world(args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg, shape, mesh_cfg, plan, tc = build(args, world)
    rank = 0
    if world > 1:
        rank = dist.get_rank()
        if args.device == "cuda":
            args.device = f"cuda:{rank % torch.cuda.device_count()}"
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
        f"shape={shape.name} {shape.seq_len}x{shape.global_batch} "
        f"mesh={mesh_cfg.shape} plan={args.plan} device={args.device}")
    trainer = Trainer(cfg, shape, mesh_cfg, tc, plan=plan,
                      device=args.device)
    if args.ckpt_dir is None and rank == 0:
        BUILD.mkdir(exist_ok=True)
        args.ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_", dir=BUILD)
    if world > 1:                     # every rank saves into rank 0's
        box = [args.ckpt_dir]
        dist.broadcast_object_list(box, src=0)
        args.ckpt_dir = box[0]
    ckpt = CheckpointManager(args.ckpt_dir, keep=tc.keep_checkpoints)
    runner = FaultTolerantRunner(trainer, ckpt)

    def data(step):
        batch = lm_batch(cfg, shape, step, seed=tc.seed, device=args.device)
        if cfg.frontend != "none":
            batch["frontend_embeds"] = synthetic_frontend_embeds(
                cfg, shape.global_batch, seed=step, device=args.device)
        return batch

    # the initial state is handed over, not kept: the runner frees each
    # step's old state as training moves on
    _, hist = runner.run(trainer.init_state(), data, args.steps,
                         log_every=max(args.steps // 20, 1))
    ckpt.wait()
    if joined:
        dist.destroy_process_group()
    for h in hist:
        say(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
            f"gnorm {h['grad_norm']:.2f}")
    return {"arch": cfg.name, "shape": (shape.seq_len, shape.global_batch),
            "mesh": mesh_cfg.shape, "history": hist,
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
