"""Checkpoints across meshes, elastic restart and the train launcher's
meshes on ``torch.distributed`` gloo ranks.

The port of ``tests/test_distributed.py::
test_elastic_restart_across_mesh_shapes`` (a state saved on ``(2, 4)``
after three steps restores on ``(1, 8)`` and ``(4, 2)`` bit for bit, and a
step runs), a one-device checkpoint restored on ``(2, 1)`` and back, and
``FaultTolerantRunner`` restarting onto ``elastic.surviving_mesh`` after
two of four ranks leave; then ``launch/train.py --mesh local`` under
``torch.distributed.run`` (the pod meshes' refusal is
``tests/test_torch_frontends.py``).  Each world (2, 4
and 8 ranks) is spawned once as subprocesses joined through a
``FileStore`` under ``tmp_path``, torch pinned to one thread a rank.  The
reference's own elastic test fails on jax 0.9 (ROADMAP.md queue 3); these
hold the port to the same assertions and to its one-device ``Trainer``.

Tolerance: where a restart moves a run onto another mesh, the steps after
it agree with the uninterrupted run's within the f32 bounds that
``tests/test_torch_sharded_train.py`` (``ONE_TOL``) holds a mesh to one
device: the gradient mean and the global norm are summed in another order.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import lm_batch
from repro_torch.runtime import train_loop as ttrain

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 32
TC_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50, seed=0)
WORLDS = (2, 4, 8)
FT_STEPS, FT_FAULT_AT = 5, 2
LATE_S = 3.0                  # rank 1's delay: rank 0's baseline commits
# f32: loss and grad-norm rtol, max and mean |param diff|, leaf error over
# its norm (test_torch_sharded_train.ONE_TOL)
ONE_TOL = (1e-6, 1e-5, 1e-3, 1e-6, 1e-4)


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _cfg(**kw):
    base = dict(name="tiny", family="dense", num_layers=2, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                remat=False)
    base.update(kw)
    return ModelConfig(**base)


def _data(cfg):
    shape = ShapeConfig("t", S, B, "train")
    return lambda s: lm_batch(cfg, shape, s, device="cpu")


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:             # a copy: the Trainer updates its state in place
            out[f"{prefix}/{k}"] = v.detach().float().numpy().copy()


def _sub(arrays, prefix) -> dict:
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix + "/")}


def _shards_ok(tr, state) -> bool:
    """Each leaf of the rank's state is the slice of the gathered tensor
    that ``shard_slices`` gives its coordinate."""
    from repro_torch import sharding as sh
    full = tr.state_shardings.unshard(state)
    return all(torch.equal(loc, whole[sh.shard_slices(
        sp, whole.shape, tr.mesh_cfg, tr.placement.coord)])
        for loc, whole, sp in zip(tree_leaves(state), tree_leaves(full),
                                  tree_leaves(tr.state_specs)))


# ---------------------------------------------------------------------------
# one rank, run as ``python tests/test_torch_elastic_restart.py RANK WORLD
# DIR``
# ---------------------------------------------------------------------------
class Departed(Exception):
    """A rank that did not survive the injected fault leaves the run."""


def _world2(rank, d, res):
    """A one-device checkpoint restores on (2, 1), trains a step, and the
    (2, 1) checkpoint restores on one device."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    cfg, shape, tc = _cfg(), ShapeConfig("t", S, B, "train"), \
        TrainConfig(**TC_KW)
    ck = CheckpointManager(os.path.join(d, "ckpt_one"))
    one = ttrain.Trainer(cfg, shape, MeshConfig((1, 1), _axes((1, 1))), tc,
                         device="cpu")
    if rank == 0:
        st, _ = one.run(one.init_state(), _data(cfg), 2)
        ck.save(2, st, blocking=True)
        _flatten(st.params, "one/saved", res)
    dist.barrier()
    tr = ttrain.Trainer(cfg, shape, MeshConfig((2, 1), _axes((2, 1))), tc,
                        device="cpu")
    st, step = ck.restore(tr.state_like(), device="cpu",
                          shardings=tr.state_shardings)
    res["one/restored_step"] = np.array(step)
    _flatten(tr.param_shardings.unshard(st.params), "one/on2x1", res)
    res["one/shards_ok"] = np.array(_shards_ok(tr, st))
    st, hist = tr.run(st, _data(cfg), 1, log_every=1)
    ck.save(3, st, blocking=True, shardings=tr.state_shardings)
    _flatten(tr.param_shardings.unshard(st.params), "one/after", res)
    res["one/loss"] = np.array([h["loss"] for h in hist])
    back, step = ck.restore(one.state_like(), step=3, device="cpu")
    _flatten(back.params, "one/back", res)
    res["one/back_step"] = np.array(step)
    res["one/back_count"] = back.opt.count.numpy()
    _late_rank(rank, d, res)


def _late_rank(rank, d, res):
    """``FaultTolerantRunner`` on (2, 1) with a replicated state (no
    ``fsdp``: its save gathers nothing) when rank 1 reaches ``run`` after
    rank 0's step-0 baseline is on disk: both must still take the save."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.fault import FaultTolerantRunner
    cfg = _cfg()
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig((2, 1), _axes((2, 1))),
                        TrainConfig(**TC_KW, checkpoint_every=1),
                        device="cpu")
    ck = CheckpointManager(os.path.join(d, "ckpt_late"), keep=5)
    st = tr.init_state()
    dist.barrier()
    if rank == 1:
        time.sleep(LATE_S)
    st, hist = FaultTolerantRunner(tr, ck).run(st, _data(cfg), 2,
                                               log_every=1)
    ck.wait()
    res["late/steps"] = np.array(ck.steps())
    res["late/loss"] = np.array([h["loss"] for h in hist])


def _world4(rank, d, res):
    """An uninterrupted (2, 2) run, then the same run faulted at step
    ``FT_FAULT_AT``: ranks 2 and 3 leave, 0 and 1 form a new group and
    ``rebuild`` puts a Trainer on ``elastic.surviving_mesh``."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime import elastic
    from repro_torch.runtime.fault import FaultInjector, FaultTolerantRunner
    cfg = _cfg()
    shape = ShapeConfig("t", S, B, "train")
    tc = TrainConfig(**TC_KW, checkpoint_every=1)
    plan = PartitionPlan.uniform(cfg.num_layers, PrecisionPolicy.fp32())
    mesh = MeshConfig((2, 2), ("data", "model"))
    tr = ttrain.Trainer(cfg, shape, mesh, tc, plan=plan, device="cpu")
    st, hist = tr.run(tr.init_state(), _data(cfg), FT_STEPS, log_every=1)
    res["ft/ref_loss"] = np.array([h["loss"] for h in hist])
    res["ft/ref_grad_norm"] = np.array([h["grad_norm"] for h in hist])
    _flatten(tr.param_shardings.unshard(st.params), "ft/ref", res)
    survivors = elastic.surviving_mesh(mesh, 2)
    res["ft/survivors"] = np.array(survivors.shape)

    def rebuild():
        dist.destroy_process_group()
        if rank >= survivors.num_devices:
            raise Departed()
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(d, "store_ft"),
                                         survivors.num_devices),
            rank=rank, world_size=survivors.num_devices)
        return ttrain.Trainer(cfg, shape, survivors, tc, plan=plan,
                              device="cpu")

    tr = ttrain.Trainer(cfg, shape, mesh, tc, plan=plan, device="cpu")
    ck = CheckpointManager(os.path.join(d, "ckpt_ft"), keep=10)
    runner = FaultTolerantRunner(tr, ck, max_restarts=1, rebuild=rebuild)
    try:
        st, hist = runner.run(tr.init_state(), _data(cfg), FT_STEPS,
                              on_step=FaultInjector({FT_FAULT_AT}),
                              log_every=1)
    except Departed:
        res["ft/departed"] = np.array(True)
        return
    ck.wait()
    res["ft/restarts"] = np.array(runner.restarts)
    res["ft/mesh"] = np.array(runner.trainer.mesh_cfg.shape)
    res["ft/loss"] = np.array([h["loss"] for h in hist])
    res["ft/grad_norm"] = np.array([h["grad_norm"] for h in hist])
    res["ft/steps"] = np.array([h["step"] for h in hist])
    _flatten(runner.trainer.param_shardings.unshard(st.params), "ft/got",
             res)


def _world8(rank, d, res):
    """Save on (2, 4) after three steps, restore on (1, 8) and (4, 2)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    cfg = _cfg(num_heads=8, num_kv_heads=8)
    shape = ShapeConfig("t", S, B, "train")
    tc = TrainConfig()
    tr = ttrain.Trainer(cfg, shape, MeshConfig((2, 4), _axes((2, 4))), tc,
                        device="cpu")
    st, _ = tr.run(tr.init_state(), _data(cfg), 3)
    ck = CheckpointManager(os.path.join(d, "ckpt_elastic"))
    ck.save(3, st, blocking=True, shardings=tr.state_shardings)
    _flatten(tr.param_shardings.unshard(st.params), "elastic/2x4", res)
    for ms in ((1, 8), (4, 2)):
        tr2 = ttrain.Trainer(cfg, shape, MeshConfig(ms, _axes(ms)), tc,
                             device="cpu")
        got, step = ck.restore(tr2.state_like(), device="cpu",
                               shardings=tr2.state_shardings)
        name = "x".join(map(str, ms))
        res[f"elastic/{name}/step"] = np.array(step)
        res[f"elastic/{name}/shards_ok"] = np.array(_shards_ok(tr2, got))
        _flatten(tr2.param_shardings.unshard(got.params),
                 f"elastic/{name}", res)
        got, m = tr2.step_fn(got, lm_batch(cfg, shape, 3, device="cpu"))
        res[f"elastic/{name}/next_loss"] = np.asarray(float(m["loss"]))


def _rank(rank: int, world: int, d: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    # collectives that ranks run out of step fail within the timeout
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, f"store{world}"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        {2: _world2, 4: _world4, 8: _world8}[world](rank, d, res)
        np.savez(os.path.join(d, f"w{world}_rank{rank}.npz"), **res)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _env():
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{world: [rank results]}``: every world's ranks run at once."""
    d = tmp_path_factory.mktemp("elastic")
    procs = {world: [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(d)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)] for world in WORLDS}
    for ps in procs.values():
        for p in ps:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
    return {world: [dict(np.load(d / f"w{world}_rank{r}.npz"))
                    for r in range(world)] for world in WORLDS}


@pytest.mark.parametrize("ms", ("1x8", "4x2"))
def test_elastic_restart_across_mesh_shapes(runs, ms):
    """Saved on (2, 4) after three steps, restored on ``ms``: the
    parameters bit-equal, every rank's part its slice, then a step runs."""
    for got in runs[8]:
        assert int(got[f"elastic/{ms}/step"]) == 3
        assert bool(got[f"elastic/{ms}/shards_ok"])
        assert np.isfinite(got[f"elastic/{ms}/next_loss"])
    got = runs[8][0]
    saved = _sub(got, "elastic/2x4")
    assert saved
    for k, v in saved.items():
        np.testing.assert_array_equal(got[f"elastic/{ms}{k}"], v)


def test_one_device_checkpoint_restores_on_2x1_and_back(runs):
    got = runs[2]
    saved = _sub(got[0], "one/saved")
    assert saved
    for r in got:
        assert int(r["one/restored_step"]) == 2 and bool(r["one/shards_ok"])
        for k, v in saved.items():
            np.testing.assert_array_equal(r[f"one/on2x1{k}"], v)
        # the (2, 1) checkpoint read back on one device
        assert int(r["one/back_step"]) == 3 and int(r["one/back_count"]) == 3
        for k in saved:
            np.testing.assert_array_equal(r[f"one/back{k}"],
                                          got[0][f"one/after{k}"])
    assert np.isfinite(got[0]["one/loss"]).all()


def test_fault_tolerant_runner_agrees_on_the_baseline_save(runs):
    """A rank that reaches the runner late still takes the step-0 save:
    every rank runs the same collectives, and both ranks' runs end with
    the same steps saved and the same losses."""
    got = runs[2]
    for r in got:
        assert list(r["late/steps"]) == [0, 1, 2]
        np.testing.assert_array_equal(r["late/loss"], got[0]["late/loss"])
    assert np.isfinite(got[0]["late/loss"]).all()


def test_fault_tolerant_runner_continues_on_the_surviving_mesh(runs):
    """The steps before the fault are the uninterrupted run's bit for bit;
    after it the (1, 2) mesh splits no batch rows, so the steps agree with
    the (2, 2) run's within ``ONE_TOL``."""
    out = runs[4]
    assert all(bool(r["ft/departed"]) for r in out[2:])
    l_tol, n_tol, max_tol, mean_tol, leaf_tol = ONE_TOL
    for r in out[:2]:
        assert list(r["ft/survivors"]) == [1, 2]
        assert int(r["ft/restarts"]) == 1 and list(r["ft/mesh"]) == [1, 2]
        assert list(r["ft/steps"]) == list(range(1, FT_STEPS + 1))
        ref_l, ref_n = r["ft/ref_loss"], r["ft/ref_grad_norm"]
        np.testing.assert_array_equal(r["ft/loss"][:FT_FAULT_AT],
                                      ref_l[:FT_FAULT_AT])
        np.testing.assert_array_equal(r["ft/grad_norm"][:FT_FAULT_AT],
                                      ref_n[:FT_FAULT_AT])
        np.testing.assert_allclose(r["ft/loss"], ref_l, rtol=l_tol)
        np.testing.assert_allclose(r["ft/grad_norm"], ref_n, rtol=n_tol)
        want, have = _sub(r, "ft/ref"), _sub(r, "ft/got")
        assert sorted(have) == sorted(want)
        for k in want:
            d = np.abs(have[k] - want[k])
            assert d.max() <= max_tol and d.mean() <= mean_tol, k
            assert np.linalg.norm(have[k] - want[k]) <= \
                leaf_tol * np.linalg.norm(want[k]), k


def test_launch_train_runs_under_torchrun(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", "stablelm-1.6b", "--smoke", "--steps", "2",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--ckpt-every", "1"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "mesh=(2, 1)" in res.stdout
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2, res.stdout       # rank 0 alone prints
    assert (tmp_path / "ckpt" / "step_00000002").is_dir()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
