"""AdamW on bf16 gradients against the reference: ``clip_by_global_norm``
and ``apply_updates`` (pure and donated) on a small tree whose bf16
gradients have a global norm of ~640 against ``grad_clip`` 1.0, and one
``make_step_fn`` step of ``tiny_dense`` with ``grad_accum=2`` and
``accum_dtype="bfloat16"`` (the ``Trainer``'s path to bf16 gradients),
each against the jitted reference.

The reference's ``g * scale`` (a bf16 leaf times a 0-dim f32 array)
promotes to f32 before the clipped gradient reaches the moments; torch
keeps a bf16 tensor's dtype when it multiplies a 0-dim f32 tensor, so the
port widens first.  Tolerances: the update's parameters and moments within
``OPT_TOL`` of each leaf's largest magnitude (the global norms may part by
an ulp, which moves the clip factor by as much); rounding the clipped
gradient to bf16 parts them by ~2**-9.  The step's moments within
``STEP_MOMENT_TOL`` of each leaf's norm: the port's and the reference's f32
gradients part in their last bits, so a few accumulated bf16 elements round
the other way (one bf16 ulp: up to 1.8e-4 of the norm measured); a
bf16-rounded clipped gradient parts every element (1.6e-3 measured).  The
reference runs jitted in a subprocess with XLA's excess precision off
(``test_torch_train.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.tiny import TINY
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.tree import tree_leaves
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import train_loop as ttrain

ROOT = Path(__file__).resolve().parents[1]
# leaves of the update's tree: decayed (ndim >= 2) and not
LEAVES = {"w": (64, 64), "b": (33,), "stack": (3, 17, 8)}
GNORM = 640.0                 # the bf16 gradients' global norm
TC_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50,
             checkpoint_every=5, seed=0, grad_clip=1.0)
STATES = ("fresh", "count3")  # zero moments at count 0; moments at count 3
B, S = 4, 16
OPT_TOL = 1e-5
STEP_MOMENT_TOL = 5e-4


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


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


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _opt_inputs(state):
    """(params, f32 gradients to round to bf16, mu, nu, count) as numpy.
    The moments at count 3 are of the clipped gradients' size, so that
    the new gradient's share of each is about half."""
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in LEAVES.items()}
    g = {k: rng.normal(size=s) for k, s in LEAVES.items()}
    norm = np.sqrt(sum(np.sum(a * a) for a in g.values()))
    g = {k: (a * GNORM / norm).astype(np.float32) for k, a in g.items()}
    if state == "fresh":
        zeros = lambda: {k: np.zeros(s, np.float32)
                         for k, s in LEAVES.items()}
        return params, g, zeros(), zeros(), 0
    clipped = {k: a / GNORM for k, a in g.items()}
    mu = {k: (0.1 * a * rng.normal(size=a.shape)).astype(np.float32)
          for k, a in clipped.items()}
    nu = {k: (0.05 * a * a * rng.uniform(0.5, 1.5, size=a.shape)).astype(
        np.float32) for k, a in clipped.items()}
    return params, g, mu, nu, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_adamw.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.core.partition import PartitionPlan
    from repro.core.precision import PrecisionPolicy
    from repro.data.pipeline import lm_batch
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.runtime.train_loop import TrainState, make_step_fn
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    res = {}
    tc = TrainConfig(**TC_KW)
    bf16 = lambda tree: {k: jnp.asarray(a).astype(jnp.bfloat16)
                         for k, a in tree.items()}
    for state in STATES:
        params, g, mu, nu, count = _opt_inputs(state)
        clipped, gnorm = jax.jit(
            lambda gr: adamw.clip_by_global_norm(gr, tc.grad_clip))(bf16(g))
        _flatten(clipped, f"clip/{state}", res)
        res[f"clip/{state}/gnorm"] = np.asarray(gnorm)
        opt = adamw.AdamWState(mu, nu, jnp.asarray(count, jnp.int32))
        new, new_opt, gnorm = jax.jit(
            lambda p, gr, o: adamw.apply_updates(p, gr, o, tc))(
                params, bf16(g), opt)
        _flatten({"params": new, "mu": new_opt.mu, "nu": new_opt.nu},
                 f"opt/{state}", res)
        res[f"opt/{state}/gnorm"] = np.asarray(gnorm)

    cfg = tiny_dense(grad_accum=2)
    tc = TrainConfig(accum_dtype="bfloat16", **TC_KW)
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    _flatten(params, "lm/params", res)
    plan = PartitionPlan.uniform(cfg.num_layers, PrecisionPolicy.fp32())
    step = jax.jit(make_step_fn(cfg, tc, plan, 1))
    state = TrainState(params, adamw.init(params, jnp.float32),
                       jnp.zeros((), jnp.int32))
    state, m = step(state, lm_batch(cfg, ShapeConfig("t", S, B, "train"), 0))
    _flatten({"params": state.params, "mu": state.opt.mu,
              "nu": state.opt.nu}, "step", res)
    res["step/loss"] = np.asarray(m["loss"])
    res["step/grad_norm"] = np.asarray(m["grad_norm"])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("adamw_ref") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def _torch(tree, dtype=torch.float32):
    """Copies (a donated update writes into them)."""
    return {k: torch.tensor(a, dtype=dtype) for k, a in tree.items()}


def _max_rel(got, want):
    """max |got - want| over max |want| of one leaf."""
    return float(np.abs(_f32(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("state", STATES)
def test_clip_widens_bf16_gradients_as_the_reference(ref, state):
    _, g, _, _, _ = _opt_inputs(state)
    clipped, gnorm = tadamw.clip_by_global_norm(
        _torch(g, torch.bfloat16), TC_KW["grad_clip"])
    want = float(ref[f"clip/{state}/gnorm"])
    assert abs(float(gnorm) - want) <= 1e-6 * want
    for k in LEAVES:
        assert clipped[k].dtype == torch.float32, k
        assert _max_rel(clipped[k], ref[f"clip/{state}/{k}"]) <= OPT_TOL, k


@pytest.mark.parametrize("donate", [False, True], ids=["pure", "donated"])
@pytest.mark.parametrize("state", STATES)
def test_bf16_gradients_under_a_biting_clip_equal_the_reference(
        ref, state, donate, monkeypatch):
    """``apply_updates`` with bf16 gradients of norm ~640 and
    ``grad_clip`` 1.0: parameters, moments and the global norm as the
    jitted reference's; donated a few rows at a time, as pure."""
    monkeypatch.setattr(tadamw, "DONATE_BLOCK", 64)
    params, g, mu, nu, count = _opt_inputs(state)
    opt = tadamw.AdamWState(_torch(mu), _torch(nu),
                            torch.tensor(count, dtype=torch.int32))
    new, new_opt, gnorm = tadamw.apply_updates(
        _torch(params), _torch(g, torch.bfloat16), opt, TTrain(**TC_KW),
        donate=donate)
    want = float(ref[f"opt/{state}/gnorm"])
    assert abs(float(gnorm) - want) <= 1e-6 * want
    assert int(new_opt.count) == count + 1
    for name, tree in (("params", new), ("mu", new_opt.mu),
                       ("nu", new_opt.nu)):
        for k in LEAVES:
            assert tree[k].dtype == torch.float32
            err = _max_rel(tree[k], ref[f"opt/{state}/{name}/{k}"])
            assert err <= OPT_TOL, (name, k, err)


def test_a_bf16_accumulated_step_equals_the_reference(ref):
    """One ``make_step_fn`` step of ``tiny_dense`` under the f32 plan with
    two microbatches summed in bf16, from the reference's parameters:
    loss, gradient norm, parameters and moments."""
    cfg = TINY.with_(grad_accum=2)
    tc = TTrain(accum_dtype="bfloat16", **TC_KW)
    params = bridge.to_torch(_unflatten(ref, "lm/params"), "cpu")
    state = ttrain.TrainState(params, tadamw.init(params),
                              torch.zeros((), dtype=torch.int32))
    plan = TPlan.uniform(cfg.num_layers, TPolicy.fp32())
    step = ttrain.make_step_fn(cfg, tc, plan, 1)
    state, m = step(state, tpipe.lm_batch(cfg, TShape("t", S, B, "train"),
                                          0, device="cpu"))
    want_l, want_n = float(ref["step/loss"]), float(ref["step/grad_norm"])
    assert abs(float(m["loss"]) - want_l) <= 1e-6 * want_l
    # the norm of bf16 sums: a few elements one bf16 ulp apart
    assert abs(float(m["grad_norm"]) - want_n) <= 1e-4 * want_n
    assert want_n > tc.grad_clip           # the clip bites
    for name, tree in (("params", state.params), ("mu", state.opt.mu),
                       ("nu", state.opt.nu)):
        got, want = {}, {}
        _flatten(tree, "", got)
        _flatten(_unflatten(ref, f"step/{name}"), "", want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32, (name, k)
            if name == "params":
                # a first Adam step is +-lr a weight whatever the error
                d = np.abs(got[k] - want[k])
                assert d.max() <= 2.2 * tc.learning_rate, (k, d.max())
                assert d.mean() <= 1e-6, (k, d.mean())
                continue
            err = (np.linalg.norm(got[k] - want[k])
                   / max(np.linalg.norm(want[k]), 1e-30))
            assert err <= STEP_MOMENT_TOL, (name, k, err)


def test_f32_gradients_update_exactly_as_before():
    """The widening is the identity on f32 gradients: the clipped tree is
    ``g * scale`` itself, bit for bit."""
    _, g, _, _, _ = _opt_inputs("fresh")
    grads = _torch(g)
    clipped, gnorm = tadamw.clip_by_global_norm(grads, TC_KW["grad_clip"])
    scale = torch.clamp_max(TC_KW["grad_clip"]
                            / torch.clamp_min(gnorm, 1e-9), 1.0)
    for k in LEAVES:
        assert torch.equal(clipped[k], grads[k] * scale)
    assert all(t.dtype == torch.float32 for t in tree_leaves(clipped))


if __name__ == "__main__":
    _reference(sys.argv[1])
