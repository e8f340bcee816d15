"""RWKV-6 3B's step-1 gradient norms under the f32, bf16 and ``"mpai"``
training plans, at its full width (d 2560, 40 heads of 64, d_ff 8960,
vocab 65536), ``--layers`` deep, on 2 x ``--seq`` tokens, from the
reference's ``model_init(PRNGKey(0))``: the reference's (jitted, XLA's
excess precision off, in a subprocess) and the port's on the bridged
weights, then the reference's again with the embedding scaled by ``1 +
eps`` for each ``eps`` of ``EPS`` (a perturbation a few ulps wide).  Not a
test: a tool for the question whether the bf16 and ``"mpai"`` plans' norms
are a property of the model or of the port.  Prints one JSON object.

    PYTHONPATH=src python tests/rwkv6_plan_norms.py --layers 2 --seq 32

Needs ~10 GB of host memory at 4 layers (both packages' parameters and
gradients at full width).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("f32", "bf16", "mpai")
EPS = (2.0 ** -20, -2.0 ** -20, 2.0 ** -16)
BATCH = 2


def _reference(layers: int, seq: int, d: str) -> None:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.core.precision import PrecisionPolicy
    from repro.data.pipeline import lm_batch
    from repro.models import transformer as T
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_sharded_train import _flatten

    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=layers,
                              remat=False)
    params = jax.jit(lambda k: T.model_init(k, cfg))(jax.random.PRNGKey(0))
    w = {}
    _flatten(params, "w", w)
    np.savez(os.path.join(d, "weights.npz"), **w)
    batch = lm_batch(cfg, ShapeConfig("t", seq, BATCH, "train"), 0)
    res = {}
    for pname in PLANS:
        plan = (qat.train_plan(PartitionPlan.mpai(layers)) if pname == "mpai"
                else PartitionPlan.uniform(layers, PrecisionPolicy.fp32())
                if pname == "f32" else None)
        grad = jax.jit(jax.value_and_grad(lambda p: T.loss_fn(
            p, cfg, batch["tokens"], batch["labels"], plan)))
        for eps in (0.0,) + EPS:
            loss, g = grad(dict(params, embed=params["embed"] * (1 + eps)))
            norm = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                                for x in jax.tree_util.tree_leaves(g)))
            res.setdefault(pname, []).append(
                {"eps": eps, "loss": float(loss), "grad_norm": float(norm)})
    with open(os.path.join(d, "ref.json"), "w") as f:
        json.dump(res, f)


def _port(layers: int, seq: int, d: str) -> dict:
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.core.precision import PrecisionPolicy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.models import transformer as T
    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_sharded_train import _unflatten

    cfg = get_config("rwkv6-3b").with_(num_layers=layers, remat=False)
    params = bridge.to_torch(_unflatten(dict(np.load(
        os.path.join(d, "weights.npz"))), "w"), "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = lm_batch(cfg, ShapeConfig("t", seq, BATCH, "train"), 0,
                     device="cpu")
    res = {}
    for pname in PLANS:
        plan = (qat.train_plan(PartitionPlan.mpai(layers)) if pname == "mpai"
                else PartitionPlan.uniform(layers, PrecisionPolicy.fp32())
                if pname == "f32" else None)
        loss = T.loss_fn(params, cfg, batch["tokens"], batch["labels"], plan)
        grads = torch.autograd.grad(loss, leaves)
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads))
        res[pname] = {"loss": float(loss.detach()), "grad_norm": float(norm)}
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        flags = (os.environ.get("XLA_FLAGS", "")
                 + " --xla_allow_excess_precision=false").strip()
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        subprocess.run([sys.executable, __file__, "ref", str(args.layers),
                        str(args.seq), d], env=env, check=True)
        port = _port(args.layers, args.seq, d)
        with open(os.path.join(d, "ref.json")) as f:
            ref = json.load(f)
    print(json.dumps({"config": "rwkv6-3b", "layers": args.layers,
                      "tokens": [BATCH, args.seq], "port": port,
                      "reference": ref}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["ref"]:
        _reference(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
