"""Checkpoints and fault-tolerant restart on the port
(``checkpoint/manager.py``, ``runtime/fault.FaultTolerantRunner``): the
ports of ``tests/test_runtime.py``'s ``TestCheckpoint`` and
``TestFaultTolerance`` (the replay bit-equal to the uninterrupted run,
within torch), and the on-disk layout shared with the reference: a
checkpoint the reference writes restores into the port through
``bridge``, one the port writes restores into the reference.

The reference's ``TestFaultTolerance`` fails on jax 0.9 (its ``Trainer``,
ROADMAP.md queue 3), so replay is held within the port; the reference here
only writes and reads files, in process.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import (MeshConfig as TMesh,
                                      ShapeConfig as TShape,
                                      TrainConfig as TTrain)
from repro_torch.configs.tiny import TINY
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.pipeline import lm_batch
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime.fault import FaultInjector, FaultTolerantRunner
from repro_torch.runtime.train_loop import Trainer, TrainState

MESH1 = TMesh((1, 1), ("data", "model"))
SHAPE = TShape("t", 32, 4, "train")
TC = TTrain(learning_rate=1e-2, warmup_steps=2, total_steps=50,
            checkpoint_every=5, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(tc=TC, **kw):
    return Trainer(TINY.with_(**kw), SHAPE, MESH1, tc, device="cpu")


def _data(cfg):
    return lambda step: lm_batch(cfg, SHAPE, step, device="cpu")


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tr = _trainer()
        state = tr.init_state()
        state, _ = tr.run(state, _data(tr.cfg), 2)     # nonzero moments
        mgr = CheckpointManager(str(tmp_path), keep=2)
        mgr.save(7, state, blocking=True)
        restored, step = mgr.restore(tr.state_like(), device="cpu")
        assert step == 7
        assert isinstance(restored, TrainState)
        _assert_trees_equal(state, restored)

    def test_gc_keeps_last_k(self, tmp_path):
        tr = _trainer()
        state = tr.init_state()
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, state, blocking=True)
        assert mgr.steps() == [3, 4]

    def test_tmp_dirs_ignored(self, tmp_path):
        os.makedirs(tmp_path / "step_00000009.tmp")
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(_trainer().state_like(), device="cpu")

    def test_layout_and_keys_are_the_references(self, tmp_path):
        tr = _trainer()
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, tr.init_state(), blocking=True)
        path = tmp_path / "step_00000003"
        assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
        manifest = json.loads((path / "manifest.json").read_text())
        with np.load(path / "arrays.npz") as z:
            keys = set(z.files)
            assert z[".step"].dtype == np.int32 and z[".step"].shape == ()
        assert manifest["step"] == 3 and manifest["num_arrays"] == len(keys)
        assert {".step", ".opt/.count", ".params/embed", ".opt/.mu/embed",
                ".opt/.nu/lm_head", ".params/layers/sub_0/mixer/wq",
                ".params/final_norm/scale"} <= keys

    def test_bf16_leaves_keep_their_bits(self, tmp_path):
        tree = {"w": torch.randn(5, 7).bfloat16(), "n": [torch.arange(3)]}
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, tree, blocking=True)
        with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
            assert z["w"].dtype == np.dtype("V2")   # as ml_dtypes' bf16
        like = tree_map(lambda t: t.to("meta"), tree)
        restored, _ = mgr.restore(like, device="cpu")
        _assert_trees_equal(tree, restored)

    def test_a_write_error_surfaces_on_the_next_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        (tmp_path / "step_00000002.tmp").write_text("a file, not a dir")
        mgr.save(2, {"x": torch.ones(2)})
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()                     # raised once


class TestFaultTolerance:
    def test_recovery_reproduces_uninterrupted_run(self, tmp_path):
        # uninterrupted reference
        tr_ref = _trainer()
        s_ref = tr_ref.init_state()
        s_ref, h_ref = tr_ref.run(s_ref, _data(tr_ref.cfg), 12, log_every=1)

        # faulty run: injected failures at steps 4 and 9
        tr = _trainer()
        state = tr.init_state()
        mgr = CheckpointManager(str(tmp_path), keep=3)
        runner = FaultTolerantRunner(tr, mgr, max_restarts=5)
        inj = FaultInjector(fail_at_steps={4, 9})
        state, hist = runner.run(state, _data(tr.cfg), 12, on_step=inj)
        assert runner.restarts == 2
        assert int(state.step) == 12
        # per-step history survives the mid-segment faults: contiguous
        # steps 1..12, each metric bit-matching the uninterrupted run
        assert [h["step"] for h in hist] == list(range(1, 13))
        assert [h["loss"] for h in hist] == [h["loss"] for h in h_ref]
        assert ([h["grad_norm"] for h in hist]
                == [h["grad_norm"] for h in h_ref])
        _assert_trees_equal(s_ref, state)

    def test_restart_budget_enforced(self, tmp_path):
        tr = _trainer()
        state = tr.init_state()
        mgr = CheckpointManager(str(tmp_path))
        runner = FaultTolerantRunner(tr, mgr, max_restarts=1)
        inj = FaultInjector(fail_at_steps={1, 2, 3, 4, 5})
        with pytest.raises(RuntimeError, match="exceeded"):
            runner.run(state, _data(tr.cfg), 8, on_step=inj)

    def test_rebuild_replaces_the_trainer(self, tmp_path):
        tc = TTrain(**{**TC.__dict__, "checkpoint_every": 1})
        tr = _trainer(tc)
        built = []

        def rebuild():
            built.append(_trainer(tc))
            return built[-1]
        runner = FaultTolerantRunner(tr, CheckpointManager(str(tmp_path)),
                                     rebuild=rebuild)
        state, hist = runner.run(tr.init_state(), _data(tr.cfg), 3,
                                 on_step=FaultInjector({1}))
        assert len(built) == 1 and runner.trainer is built[0]
        assert int(state.step) == 3 and len(hist) == 3


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------
def _reference_state():
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.runtime.train_loop import TrainState as JState
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from conftest import tiny_dense
    params = T.model_init(jax.random.PRNGKey(0), tiny_dense())
    opt = adamw.init(params, jnp.float32)
    opt = opt._replace(mu=jax.tree_util.tree_map(lambda p: p * 0.5, params),
                       nu=jax.tree_util.tree_map(lambda p: p * p, params),
                       count=jnp.asarray(4, jnp.int32))
    return JState(params, opt, jnp.asarray(4, jnp.int32))


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    import jax
    from repro.checkpoint.manager import CheckpointManager as JManager
    state = _reference_state()
    JManager(str(tmp_path)).save(4, state, blocking=True)
    restored, step = CheckpointManager(str(tmp_path)).restore(
        _trainer().state_like(), device="cpu")
    assert step == 4 and int(restored.step) == 4
    assert int(restored.opt.count) == 4
    want = bridge.to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}),
        "cpu")
    _assert_trees_equal(want["params"], restored.params)
    _assert_trees_equal(want["mu"], restored.opt.mu)
    _assert_trees_equal(want["nu"], restored.opt.nu)


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    import jax
    from repro.checkpoint.manager import CheckpointManager as JManager
    tr = _trainer()
    state, _ = tr.run(tr.init_state(), _data(tr.cfg), 1)
    CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    like = jax.eval_shape(lambda: _reference_state())
    restored, step = JManager(str(tmp_path)).restore(like)
    assert step == 1 and int(restored.step) == 1
    got = bridge.to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": restored.params, "mu": restored.opt.mu}), "cpu")
    _assert_trees_equal(state.params, got["params"])
    _assert_trees_equal(state.opt.mu, got["mu"])
