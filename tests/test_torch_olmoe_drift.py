"""``olmoe-smoke``'s one-device drift under ``"mpai"``: steps 2 and 3 of
the port, each started from the reference's state, against the
reference's own steps, token by token at the router.

The reference runs jitted in a subprocess (XLA's excess precision off)
from its ``model_init(PRNGKey(0))``, three ``make_step_fn`` steps of
``tests/test_torch_batch_split.py``'s ``olmoe-smoke`` run (B 4 x S 1024,
per-row dispatch), its router recorded at each MoE call through
``jax.debug.callback`` (a wrapper of ``moe.moe_apply`` that recomputes the
reference's router ops inside the same jit), and writes its state after
steps 1 and 2.  The port runs step 2 from the reference's state after step
1 and step 3 from the state after step 2, its router recorded the same
way.  A token whose experts differ between the two is allowed only where
the reference's own margin (its k-th less its (k+1)-th router
probability) is under ``ROUTE_NEAR_TIE``: bf16 rounding moves a
probability by ~1e-6 (ROADMAP.md, "MoE routing").  Measured before and
after head-parallel compute landed: one token of 8192 routed parts at
step 2 (margin 3.1e-5), two at step 3 (4.4e-5, 5.7e-5), none at a wider
margin.  Each held step's loss stays within ``LOSS_REL`` of the
reference's (measured 9.5e-6 and 9.2e-6 relative: the fake-quantized
layer's codes and those tokens' experts; bound 3x).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded_train import (TC_KW, _env, _flatten,  # noqa: E402
                                      _unflatten)

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

B, S = 4, 1024
STEPS = 3
ROUTE_NEAR_TIE = 1e-4
LOSS_REL = 3e-5


def _cfg():
    from repro_torch.configs import get_config
    return get_config("olmoe-1b-7b", smoke=True)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_olmoe_drift.py DIR``
# ---------------------------------------------------------------------------
def _reference(d):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.core import qat as jqat
    from repro.core.partition import PartitionPlan as JPlan
    from repro.data.pipeline import lm_batch as jbatch
    from repro.models import moe as jmoe
    from repro.models import transformer as JT
    from repro.optim import adamw as jadamw
    from repro.runtime.train_loop import TrainState, make_step_fn

    cfg = get_config("olmoe-1b-7b", smoke=True)
    calls = []
    real = jmoe.moe_apply

    def record(ids, top):
        calls.append((np.asarray(ids), np.asarray(top)))

    def spy(params, moe, x, *args, **kw):
        # the reference's router, op for op (``moe.py:83-85``)
        xf = x.reshape(-1, x.shape[-1])
        logits = xf.astype(jnp.float32) @ params["router"].astype(
            jnp.float32)
        probs = jax.nn.softmax(logits, axis=-1)
        top, ids = jax.lax.top_k(probs, moe.top_k + 1)
        jax.debug.callback(record, ids[:, :moe.top_k], top, ordered=True)
        return real(params, moe, x, *args, **kw)
    jmoe.moe_apply = spy

    params = jax.jit(lambda k: JT.model_init(k, cfg))(jax.random.PRNGKey(0))
    res = {}
    _flatten(params, "init", res)
    tc = JTrain(**TC_KW)
    plan = jqat.train_plan(JPlan.mpai(cfg.num_layers))
    shape = JShape("t", S, B, "train")
    step = jax.jit(make_step_fn(cfg, tc, plan, 1))
    state = TrainState(params, jadamw.init(params, jnp.float32),
                       jnp.zeros((), jnp.int32))
    for t in range(STEPS):
        if t:
            _flatten(state.params, f"state{t}/params", res)
            _flatten(state.opt.mu, f"state{t}/mu", res)
            _flatten(state.opt.nu, f"state{t}/nu", res)
            res[f"state{t}/count"] = np.asarray(state.opt.count)
        del calls[:]
        state, m = step(state, jbatch(cfg, shape, t))
        jax.effects_barrier()
        res[f"step{t}/loss"] = np.asarray(m["loss"])
        for c, (ids, top) in enumerate(calls):
            res[f"step{t}/call{c}/ids"] = ids
            res[f"step{t}/call{c}/top"] = top
    np.savez(os.path.join(d, "ref.npz"), **res)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------
def _port_step(ref, t):
    """The port's step ``t`` from the reference's state after ``t`` steps:
    its loss and each MoE call's routes."""
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.models import moe
    cfg = _cfg()
    params = bridge.to_torch(_unflatten(ref, f"state{t}/params"), "cpu")
    opt = adamw.AdamWState(
        bridge.to_torch(_unflatten(ref, f"state{t}/mu"), "cpu"),
        bridge.to_torch(_unflatten(ref, f"state{t}/nu"), "cpu"),
        torch.tensor(ref[f"state{t}/count"]))
    state = ttrain.TrainState(params, opt, torch.tensor(t, dtype=torch.int32))
    step = ttrain.make_step_fn(cfg, TrainConfig(**TC_KW),
                               qat.train_plan(PartitionPlan.mpai(
                                   cfg.num_layers)), 1)
    calls = []
    real = moe.moe_apply

    def spy(params, mcfg, x, *args, **kw):
        with torch.no_grad():
            xf = x.reshape(-1, x.shape[-1])
            probs = torch.softmax(xf.float() @ params["router"].float(), -1)
            calls.append(torch.topk(probs, mcfg.top_k, dim=-1)[1].numpy())
        return real(params, mcfg, x, *args, **kw)
    moe.moe_apply = spy
    try:
        _, m = step(state, lm_batch(cfg, ShapeConfig("t", S, B, "train"), t,
                                    device="cpu"))
    finally:
        moe.moe_apply = real
    return float(m["loss"]), calls


@pytest.fixture(scope="module")
def drift(tmp_path_factory):
    """``{step: (port loss, reference loss, [(parted tokens, their
    reference margins) per MoE call])}`` for steps 2 and 3."""
    d = tmp_path_factory.mktemp("olmoe_drift")
    p = subprocess.run([sys.executable, __file__, str(d)], env=_env(),
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    ref = dict(np.load(d / "ref.npz"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for t in range(1, STEPS):
            loss, calls = _port_step(ref, t)
            k = _cfg().moe.top_k
            parts = []
            for c, ids in enumerate(calls):
                want = ref[f"step{t}/call{c}/ids"]
                top = ref[f"step{t}/call{c}/top"]
                parted = np.nonzero((np.sort(ids, -1)
                                     != np.sort(want, -1)).any(-1))[0]
                parts.append((parted, top[parted, k - 1] - top[parted, k]))
            out[t + 1] = (loss, float(ref[f"step{t}/loss"]), parts,
                          len(calls) == sum(
                              k_.startswith(f"step{t}/call")
                              and k_.endswith("/ids") for k_ in ref))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("step", [2, 3])
def test_routes_part_only_at_near_ties(drift, step):
    loss, want, parts, same_calls = drift[step]
    assert same_calls
    margins = np.concatenate([m for _, m in parts])
    assert (margins < ROUTE_NEAR_TIE).all(), margins.max()


@pytest.mark.parametrize("step", [2, 3])
def test_held_step_loss_equals_the_reference(drift, step):
    loss, want, _, _ = drift[step]
    assert abs(loss - want) <= LOSS_REL * want, (loss, want)


if __name__ == "__main__":
    _reference(sys.argv[1])
