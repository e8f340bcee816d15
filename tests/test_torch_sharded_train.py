"""Sharded training on ``torch.distributed`` gloo ranks (the mesh
``runtime/train_loop.Trainer``, ``sharding``, ``launch/mesh``) against the
reference's unsharded step and the port's one-device ``Trainer``.

Each world (2, 4 and 8 ranks) is spawned once as subprocesses joined
through a ``FileStore`` under ``tmp_path``, torch pinned to one thread a
rank, and runs all of its checks; the reference runs jitted in a
subprocess with XLA's excess precision off, and first writes the weights
(its ``model_init(PRNGKey(0))``) that the ranks bridge and start from.
The reference's own sharded ``Trainer`` fails on jax 0.9 (ROADMAP.md
queue 3), so a sharded step is held to ``jax.jit(make_step_fn(cfg, tc,
plan, 1))`` with no mesh on the same global batch (``T.loss_fn``,
``jax.value_and_grad``, ``adamw.apply_updates``).  Checkpoints across
meshes and elastic restart are ``tests/test_torch_elastic_restart.py``.

Tolerances, set from what the port's one-device ``Trainer`` shows on the
same config (``REF_TOL``, ``ONE_TOL``: loss and grad norm relative, then
each parameter's largest and mean absolute error and each leaf's error
over its L2 norm, after three steps).  Under the f32 plan the one-device
step is within 1.2e-6 on average and 7.2e-5 of a leaf's norm of the
reference's (measured), the sharded steps within 1.2e-6 and 6.9e-5; an
AdamW step divides each gradient by its own magnitude, so an element whose
per-row contributions nearly cancel moves by a visible fraction of ``lr``
when its sum is taken in another order.  The bounds are those x 4.  The
sharded step changes only the order of the sums over ranks (the gradient
mean, the global norm and, where the clip bites, its scale): it agrees
with the one-device step within 2.3e-7 on average and 1.5e-5 of a leaf's
norm (measured; bound 1e-6 and 1e-4).  A model axis of two ranks computes
head-parallel (``sharding.head_parallel``): its row-parallel products,
vocab-parallel log-sum-exp and per-leaf norm sums add the same f32 terms
in another order, which stays inside the same bounds.  Under bf16 and the
training plan's fake quantization (``"mpai"``) the bounds are
``tests/test_torch_train.py``'s ``STEP_TOL``: an early Adam step is
``+-lr`` a weight whatever the gradient's size.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.base import (MeshConfig, ModelConfig, MoEConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core import qat
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import lm_batch
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as ttrain

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 32
STEPS = 3
TC_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50, seed=0)
# (name, mesh shape, plan, grad_accum): held to the reference.  A mesh
# with a model axis of two ranks computes head-parallel
CASES = [("2x2x2", (2, 2, 2), "f32", 1), ("2x1", (2, 1), "f32", 1),
         ("1x2", (1, 2), "f32", 1), ("4x1", (4, 1), "f32", 1),
         ("2x1-ga2", (2, 1), "f32", 2), ("2x1-bf16", (2, 1), "bf16", 1),
         ("2x2", (2, 2), "f32", 1), ("1x2-mpai", (1, 2), "mpai", 1)]
WORLD_CASES = {8: ["2x2x2"], 4: ["4x1", "2x2"],
               2: ["2x1", "1x2", "2x1-ga2", "2x1-bf16", "1x2-mpai"]}
# (loss rtol, grad-norm rtol, max |param diff|, mean |param diff|, leaf
# error over its norm) after three steps (module docstring)
BF16_TOL = (2 ** -7, 5e-2, 2.2 * TC_KW["learning_rate"] * STEPS, 2e-3, None)
REF_TOL = {"f32": (1e-6, 1e-5, 1e-3, 5e-6, 3e-4), "bf16": BF16_TOL,
           "mpai": BF16_TOL}
ONE_TOL = {"f32": (1e-6, 1e-5, 1e-3, 1e-6, 1e-4), "bf16": BF16_TOL,
           "mpai": BF16_TOL}


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _cfg(name="tiny", **kw):
    """The reference test's config (``tests/test_distributed.py:113``):
    ``tiny_dense`` with ``fsdp`` on."""
    base = dict(name=name, family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                remat=False, fsdp=True)
    base.update(kw)
    return ModelConfig(**base)


def _plan(pname, n):
    """The f32 plan, the training plan's fake quantization (``"mpai"``:
    an int8 backbone, the last layer bf16) or bf16 (None)."""
    if pname == "mpai":
        return qat.train_plan(PartitionPlan.mpai(n))
    return PartitionPlan.uniform(n, PrecisionPolicy.fp32()) \
        if pname == "f32" else None


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            # a copy: the Trainer updates its state in place
            out[f"{prefix}/{k}"] = (v.detach().float().numpy().copy()
                                    if isinstance(v, torch.Tensor)
                                    else np.asarray(v))


def _unflatten(arrays, prefix):
    tree = {}
    for key, a in arrays.items():
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


def _rwkv():
    from repro_torch.configs import get_config
    return get_config("rwkv6-3b", smoke=True)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_sharded_train.py ref DIR``
# ---------------------------------------------------------------------------
def _weights(d):
    """The reference's ``model_init(PRNGKey(0))`` weights (jitted) of both
    configs, written to ``d/weights.npz`` (renamed into place: the ranks
    wait for it); both packages start from them."""
    import jax
    from repro.configs import get_config
    from repro.configs.base import ModelConfig as JConfig
    from repro.models import transformer as T
    res = {}
    jcfg = JConfig(**{k: getattr(_cfg(), k) for k in (
        "name", "family", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "remat", "fsdp")})
    for name, cfg in (("tiny", jcfg),
                      ("rwkv", get_config("rwkv6-3b", smoke=True))):
        init = jax.jit(lambda key, cfg=cfg: T.model_init(key, cfg))
        _flatten(init(jax.random.PRNGKey(0)), name, res)
    np.savez(os.path.join(d, "weights.tmp.npz"), **res)
    os.rename(os.path.join(d, "weights.tmp.npz"),
              os.path.join(d, "weights.npz"))


def _reference(d):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ModelConfig as JConfig
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.core import qat as jqat
    from repro.core.partition import PartitionPlan as JPlan
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.data.pipeline import lm_batch as jbatch
    from repro.runtime.train_loop import TrainState, make_step_fn
    from repro.optim import adamw as jadamw

    _weights(d)
    w = dict(np.load(os.path.join(d, "weights.npz")))
    base = {k: getattr(_cfg(), k) for k in (
        "name", "family", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "remat", "fsdp")}
    shape = JShape("t", S, B, "train")
    tc = JTrain(**TC_KW)
    res = {}
    runs = [(f"{p}/{ga}", JConfig(**base, grad_accum=ga), "tiny", p, STEPS)
            for p, ga in (("f32", 1), ("f32", 2), ("bf16", 1), ("mpai", 1))]
    runs.append(("rwkv", get_config("rwkv6-3b", smoke=True), "rwkv", "f32",
                 1))
    for key, cfg, wkey, pname, steps in runs:
        plan = (jqat.train_plan(JPlan.mpai(cfg.num_layers))
                if pname == "mpai" else
                JPlan.uniform(cfg.num_layers, JPolicy.fp32())
                if pname == "f32" else None)
        params = jax.tree_util.tree_map(jnp.asarray, _unflatten(w, wkey))
        step = jax.jit(make_step_fn(cfg, tc, plan, 1))
        state = TrainState(params, jadamw.init(params, jnp.float32),
                           jnp.zeros((), jnp.int32))
        for s in range(steps):
            state, m = step(state, jbatch(cfg, shape, s))
            res[f"{key}/{s}/loss"] = np.asarray(m["loss"])
            res[f"{key}/{s}/grad_norm"] = np.asarray(m["grad_norm"])
        _flatten(state.params, f"{key}/params", res)
    np.savez(os.path.join(d, "ref.npz"), **res)


# ---------------------------------------------------------------------------
# one port rank, run as ``python tests/test_torch_sharded_train.py RANK
# WORLD DIR``
# ---------------------------------------------------------------------------
def _state(tr, params):
    """The bridged weights as ``tr``'s state: this rank's parts."""
    state = ttrain.TrainState(params, adamw.init(params),
                              torch.zeros((), dtype=torch.int32))
    return state if tr.state_shardings is None else \
        tr.state_shardings.shard(state)


def _data(cfg, shape=None):
    shape = shape or ShapeConfig("t", S, B, "train")
    return lambda s: lm_batch(cfg, shape, s, device="cpu")


def _shards_ok(tr, state) -> bool:
    """Each leaf of the rank's state is the slice of the gathered tensor
    that ``shard_slices`` gives its coordinate."""
    from repro_torch import sharding as sh
    full = tr.state_shardings.unshard(state)
    pl = tr.placement
    return all(torch.equal(loc, whole[sh.shard_slices(
        sp, whole.shape, tr.mesh_cfg, pl.coord)])
        for loc, whole, sp in zip(tree_leaves(state), tree_leaves(full),
                                  tree_leaves(tr.state_specs)))


def _record(res, key, tr, state, hist):
    res[f"{key}/loss"] = np.array([h["loss"] for h in hist])
    res[f"{key}/grad_norm"] = np.array([h["grad_norm"] for h in hist])
    _flatten(tr.param_shardings.unshard(state.params), f"{key}/params", res)
    res[f"{key}/shards_ok"] = np.array(_shards_ok(tr, state))


def _run_case(res, name, w, rank):
    _, shape, pname, ga = next(c for c in CASES if c[0] == name)
    cfg = _cfg(grad_accum=ga)
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig(shape, _axes(shape)), TrainConfig(**TC_KW),
                        plan=_plan(pname, cfg.num_layers), device="cpu")
    state = _state(tr, bridge.to_torch(_unflatten(w, "tiny"), "cpu"))
    state, hist = tr.run(state, _data(cfg), STEPS, log_every=1)
    _record(res, name, tr, state, hist)


def _world2(rank, d, w, res):
    shape = ShapeConfig("t", S, B, "train")
    tc = TrainConfig(**TC_KW)
    # RWKV-6 smoke on (2, 1): one step from the reference's weights
    cfg = _rwkv()
    plan = _plan("f32", cfg.num_layers)
    tr = ttrain.Trainer(cfg, shape, MeshConfig((2, 1), _axes((2, 1))), tc,
                        plan=plan, device="cpu")
    state, hist = tr.run(_state(tr, bridge.to_torch(_unflatten(w, "rwkv"),
                                                    "cpu")),
                         _data(cfg), 1, log_every=1)
    _record(res, "rwkv", tr, state, hist)
    # MoE on (2, 1), routed over the global batch, and on (1, 2)
    moe = _cfg("moe", fsdp=False, moe=MoEConfig(num_experts=4, top_k=2,
                                                d_ff_expert=64))
    for key, ms in (("moe21", (2, 1)), ("moe", (1, 2))):
        tr = ttrain.Trainer(moe, shape, MeshConfig(ms, _axes(ms)), tc,
                            plan=_plan("f32", 2), device="cpu")
        state, hist = tr.run(tr.init_state(), _data(moe), 2, log_every=1)
        _record(res, key, tr, state, hist)


def _world8(rank, d, w, res):
    _run_case(res, "2x2x2", w, rank)
    # ten steps from the port's init lower the loss (the reference's test)
    cfg = _cfg()
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig((2, 2, 2), _axes((2, 2, 2))),
                        TrainConfig(learning_rate=1e-2), device="cpu")
    _, hist = tr.run(tr.init_state(), _data(cfg), 10, log_every=1)
    res["ten/loss"] = np.array([h["loss"] for h in hist])


def _wait_for(path: str, seconds: float = 300) -> None:
    """Until the reference has written ``path`` (renamed into place)."""
    import time
    end = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(path)
        time.sleep(0.1)


def _rank(rank: int, world: int, d: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, f"store{world}"), world),
        rank=rank, world_size=world)
    _wait_for(os.path.join(d, "weights.npz"))
    w = dict(np.load(os.path.join(d, "weights.npz")))
    res = {}
    try:
        if world == 2:
            for name in WORLD_CASES[2]:
                _run_case(res, name, w, rank)
            _world2(rank, d, w, res)
        elif world == 4:
            for name in WORLD_CASES[4]:
                _run_case(res, name, w, rank)
        else:
            _world8(rank, d, w, res)
        np.savez(os.path.join(d, f"w{world}_rank{rank}.npz"), **res)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _env():
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path,
                XLA_FLAGS=flags, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference results, {world: [rank results]})``: the reference and
    every world's ranks run at once."""
    d = tmp_path_factory.mktemp("sharded_train")
    procs = {"ref": [subprocess.Popen(
        [sys.executable, __file__, "ref", str(d)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]}
    for world in WORLD_CASES:
        procs[world] = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(d)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
    for ps in procs.values():
        for p in ps:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
    ref = dict(np.load(d / "ref.npz"))
    out = {world: [dict(np.load(d / f"w{world}_rank{r}.npz"))
                   for r in range(world)] for world in WORLD_CASES}
    return ref, out, dict(np.load(d / "weights.npz"))


def _world_of(name):
    return next(wd for wd, names in WORLD_CASES.items() if name in names)


def _leaf_errs(got: dict, want: dict) -> dict:
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(np.linalg.norm(want[k]), 1e-30)) for k in want}


def _one_device(w, name):
    """The port's one-device ``Trainer`` on the case's config, from the
    bridged weights: its history and final parameters."""
    _, shape, pname, ga = next(c for c in CASES if c[0] == name)
    cfg = _cfg(grad_accum=ga)
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig((1, 1), _axes((1, 1))),
                        TrainConfig(**TC_KW),
                        plan=_plan(pname, cfg.num_layers), device="cpu")
    state = _state(tr, bridge.to_torch(_unflatten(w, "tiny"), "cpu"))
    state, hist = tr.run(state, _data(cfg), STEPS, log_every=1)
    out = {}
    _flatten(state.params, "", out)
    return hist, out


# ---------------------------------------------------------------------------
# steps against the reference and the one-device Trainer
# ---------------------------------------------------------------------------
def _check(loss, gnorm, have, want_loss, want_gnorm, want, tol):
    """Histories and final parameters within ``tol`` (``REF_TOL``)."""
    l_tol, n_tol, max_tol, mean_tol, leaf_tol = tol
    assert len(loss) == len(want_loss)
    for gl, gn, wl, wn in zip(loss, gnorm, want_loss, want_gnorm):
        assert abs(gl - wl) <= l_tol * wl, (gl, wl)
        assert abs(gn - wn) <= n_tol * wn, (gn, wn)
    assert sorted(have) == sorted(want)
    for k in want:
        d = np.abs(have[k] - want[k])
        assert d.max() <= max_tol and d.mean() <= mean_tol, \
            (k, d.max(), d.mean())
    if leaf_tol is not None:
        errs = _leaf_errs(have, want)
        assert max(errs.values()) <= leaf_tol, errs


def _params(arrays, prefix) -> dict:
    out = {}
    _flatten(_unflatten(arrays, prefix), "", out)
    return out


@pytest.mark.parametrize("name,shape,pname,ga", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_steps_equal_the_reference(runs, name, shape, pname, ga):
    ref, out, _ = runs
    got = out[_world_of(name)][0]
    key = f"{pname}/{ga}"
    _check(got[f"{name}/loss"], got[f"{name}/grad_norm"],
           _params(got, f"{name}/params"),
           [float(ref[f"{key}/{s}/loss"]) for s in range(STEPS)],
           [float(ref[f"{key}/{s}/grad_norm"]) for s in range(STEPS)],
           _params(ref, f"{key}/params"), REF_TOL[pname])


@pytest.mark.parametrize("name,shape,pname,ga", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_steps_equal_the_one_device_trainer(runs, name, shape,
                                                    pname, ga):
    _, out, w = runs
    got = out[_world_of(name)][0]
    hist, want = _one_device(w, name)
    _check(got[f"{name}/loss"], got[f"{name}/grad_norm"],
           _params(got, f"{name}/params"), [h["loss"] for h in hist],
           [h["grad_norm"] for h in hist], want, ONE_TOL[pname])


@pytest.mark.parametrize("world", sorted(WORLD_CASES))
def test_every_rank_holds_its_slice_and_the_same_history(runs, world):
    _, out, _ = runs
    names = WORLD_CASES[world]
    for r, got in enumerate(out[world]):
        for name in names:
            assert bool(got[f"{name}/shards_ok"]), (world, r, name)
            for k in ("loss", "grad_norm"):
                np.testing.assert_array_equal(got[f"{name}/{k}"],
                                              out[world][0][f"{name}/{k}"])


def test_ten_steps_lower_the_loss_on_222(runs):
    losses = runs[1][8][0]["ten/loss"]
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_rwkv_smoke_on_2x1(runs):
    """One step: the loss and grad norm equal the reference's within
    ``REF_TOL``, and the step the one-device Trainer's within ``ONE_TOL``
    (an RWKV parameter after an Adam step is compared with the port's own,
    and one step only: the 0.01-scale LoRA leaves then move the next grad
    norm by more than the rounding of a sum; ROADMAP.md, "Recurrent
    gradients")."""
    ref, out, w = runs
    got = out[2][0]
    l_tol, n_tol = REF_TOL["f32"][:2]
    want_l, want_n = float(ref["rwkv/0/loss"]), float(ref["rwkv/0/grad_norm"])
    assert abs(got["rwkv/loss"][0] - want_l) <= l_tol * want_l
    assert abs(got["rwkv/grad_norm"][0] - want_n) <= n_tol * want_n
    cfg = _rwkv()
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig((1, 1), _axes((1, 1))),
                        TrainConfig(**TC_KW),
                        plan=_plan("f32", cfg.num_layers), device="cpu")
    params = bridge.to_torch(_unflatten(w, "rwkv"), "cpu")
    st, hist = tr.run(_state(tr, params), _data(cfg), 1, log_every=1)
    one = {}
    _flatten(st.params, "", one)
    _check(got["rwkv/loss"], got["rwkv/grad_norm"],
           _params(got, "rwkv/params"), [h["loss"] for h in hist],
           [h["grad_norm"] for h in hist], one, ONE_TOL["f32"])
    assert bool(got["rwkv/shards_ok"])


def test_moe_on_a_batch_split_mesh_equals_one_device(runs):
    """(2, 1) splits the batch: each rank routes its rows inside the global
    batch (the flat path's choice and the load-balancing loss over the
    batch group, ``core/collectives.py``); the steps agree with the
    one-device Trainer's within ``ONE_TOL``."""
    got = runs[1][2][0]
    cfg = _cfg("moe", fsdp=False, moe=MoEConfig(num_experts=4, top_k=2,
                                                d_ff_expert=64))
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig((1, 1), _axes((1, 1))),
                        TrainConfig(**TC_KW), plan=_plan("f32", 2),
                        device="cpu")
    st, hist = tr.run(tr.init_state(), _data(cfg), 2, log_every=1)
    want = {}
    _flatten(st.params, "", want)
    _check(got["moe21/loss"], got["moe21/grad_norm"],
           _params(got, "moe21/params"), [h["loss"] for h in hist],
           [h["grad_norm"] for h in hist], want, ONE_TOL["f32"])
    assert bool(got["moe21/shards_ok"])


def test_moe_on_the_model_axis_equals_one_device(runs):
    """(1, 2) splits no batch row, so routing sees the global batch, and
    runs the experts expert-parallel (two of the four a rank, their outputs
    all-gathered); the steps agree with the one-device Trainer's within
    ``ONE_TOL``."""
    got = runs[1][2][0]
    cfg = _cfg("moe", fsdp=False, moe=MoEConfig(num_experts=4, top_k=2,
                                                d_ff_expert=64))
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig((1, 1), _axes((1, 1))),
                        TrainConfig(**TC_KW), plan=_plan("f32", 2),
                        device="cpu")
    # the (1, 2) Trainer's init at tp 2 pads no head here: the same tree
    st, hist = tr.run(tr.init_state(), _data(cfg), 2, log_every=1)
    want = {}
    _flatten(st.params, "", want)
    _check(got["moe/loss"], got["moe/grad_norm"], _params(got, "moe/params"),
           [h["loss"] for h in hist], [h["grad_norm"] for h in hist], want,
           ONE_TOL["f32"])
    assert bool(got["moe/shards_ok"])


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2])
    else:
        _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
