"""The port's stage pipeline (``repro_torch.core.pipeline``) against
``repro.core.pipeline``.

``pipeline_apply`` runs the reference test's six GPipe schedules
(``tests/test_pipeline.py``: stages x microbatches (2,5) (4,6) (4,2) (8,3)
(2,1) (4,1), per-stage ``tanh`` bodies) on the same numpy weights and
inputs as the reference, which runs in a subprocess on 8 forced host
devices with XLA's excess precision off: the port's output is bit-equal to
its own sequential composition of the stages and within 1e-5 of the
reference's.  A bf16 handoff rounds the feed and every hidden to bf16 and
nothing else.  The two LM stages (``lm_two_stage_fns``) compose to the
monolithic ``forward``'s logits bit for bit, and
``split_lm_params_for_stages`` returns views of the weights, never
copies.  The ``cuda`` twins hold the schedules and the LM stages
bit-equal to their sequential composition with both stages on one card,
each on its own stream:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_pipeline.py
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen3_14b as tq3
from repro_torch.configs.tiny import TINY
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.pipeline import (lm_two_stage_fns, pipeline_apply,
                                       split_lm_params_for_stages)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
SCHEDULES = ((2, 5), (4, 6), (4, 2), (8, 3), (2, 1), (4, 1))
D, B = 8, 2


def _weights(num_stages: int, n_micro: int, d: int = D, b: int = B):
    rng = np.random.default_rng(100 * num_stages + n_micro)
    ws = (rng.standard_normal((num_stages, d, d)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((n_micro, b, d)).astype(np.float32)
    return ws, xs


def _stage_fns(num_stages: int):
    """The reference test's bodies: stage s is ``tanh(x @ w) + (s + 1)``
    in f32 (a bf16 handoff is widened first); the last stage returns that
    times ``num_stages``."""
    def mk(s):
        def fn(x, w):
            h = torch.tanh(x.float() @ w) + (s + 1)
            return h * (s + 1) if s == num_stages - 1 else h
        return fn
    return [mk(s) for s in range(num_stages)]


def _sequential(fns, ws, xs, hidden_dtype=torch.float32):
    outs = []
    for m in range(xs.shape[0]):
        x = xs[m].to(hidden_dtype)
        for s, fn in enumerate(fns):
            x = fn(x, ws[s])
            if s < len(fns) - 1:
                x = x.to(hidden_dtype)
        outs.append(x.float())
    return torch.stack(outs)


def _port(num_stages, n_micro, device="cpu", hidden_dtype=torch.float32):
    ws, xs = _weights(num_stages, n_micro)
    ws, xs = torch.tensor(ws, device=device), torch.tensor(xs, device=device)
    fns = _stage_fns(num_stages)
    got = pipeline_apply([device] * num_stages, fns, list(ws), xs,
                         hidden_shape=(B, D), out_shape=(B, D),
                         hidden_dtype=hidden_dtype, out_dtype=torch.float32)
    return got, _sequential(fns, ws, xs, hidden_dtype)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_pipeline.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core.pipeline import pipeline_apply as ref_apply

    res = {}
    for num_stages, n_micro in SCHEDULES:
        ws, xs = _weights(num_stages, n_micro)
        mesh = Mesh(np.array(jax.devices()[:num_stages]), ("stage",))

        def mk(s):
            def fn(x, params):
                h = jnp.tanh(x @ params) + (s + 1)
                return h, h * (s + 1)
            return fn
        outs = ref_apply(mesh, "stage", [mk(s) for s in range(num_stages)],
                         jnp.asarray(ws), jnp.asarray(xs),
                         hidden_shape=(B, D), out_shape=(B, D),
                         hidden_dtype=jnp.float32, out_dtype=jnp.float32)
        res[f"{num_stages}x{n_micro}"] = np.asarray(outs)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_ref") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=8"
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_stages,n_micro", SCHEDULES)
def test_schedule_equals_sequential_and_the_reference(ref, num_stages,
                                                      n_micro):
    got, seq = _port(num_stages, n_micro)
    assert got.shape == (n_micro, B, D) and got.dtype == torch.float32
    assert torch.equal(got, seq)
    want = ref[f"{num_stages}x{n_micro}"]
    err = float(np.abs(got.numpy() - want).max())
    assert err < 1e-5, (num_stages, n_micro, err)


@pytest.mark.parametrize("num_stages,n_micro", [(2, 5), (4, 2)])
def test_bf16_handoff_rounds_the_feed_and_each_hidden(num_stages, n_micro):
    got, seq = _port(num_stages, n_micro, hidden_dtype=torch.bfloat16)
    assert torch.equal(got, seq)
    f32, _ = _port(num_stages, n_micro)
    assert not torch.equal(got, f32)      # the rounding did happen


def test_stage_shapes_are_checked():
    ws, xs = _weights(2, 3)
    with pytest.raises(ValueError, match="hidden of shape"):
        pipeline_apply(["cpu"] * 2, _stage_fns(2), list(torch.tensor(ws)),
                       torch.tensor(xs), hidden_shape=(B, D + 1),
                       out_shape=(B, D))


def _lm(cfg, seed=0):
    params = T.model_init(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
    period = T.pattern_period(cfg)
    n_super = cfg.num_layers // period
    plan = PartitionPlan.mpai(cfg.num_layers,
                              split=(n_super // 2) * period)
    return params, plan, period


LM_CONFIGS = {"tiny": TINY,
              "qwen3-smoke": tq3.SMOKE.with_(num_layers=4, remat=False)}


@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_split_params_are_views(name):
    cfg = LM_CONFIGS[name]
    params, plan, period = _lm(cfg)
    stages = split_lm_params_for_stages(params, cfg, plan, period)
    assert sorted(stages[0]) == ["layers"]           # no zero head or norm
    assert sorted(stages[1]) == ["final_norm", "layers", "lm_head"]
    table = params["embed"] if "lm_head" not in params else params["lm_head"]
    assert stages[1]["lm_head"] is table
    assert stages[1]["final_norm"] is params["final_norm"]
    whole = tree_leaves(params["layers"])
    lo = plan.segments[0].end // period
    for s, (a, b) in enumerate(((0, lo), (lo, 2 * lo))):
        for part, leaf in zip(tree_leaves(stages[s]["layers"]), whole):
            assert (part.untyped_storage().data_ptr()
                    == leaf.untyped_storage().data_ptr())
            assert torch.equal(part, leaf[a:b])
            begin = leaf.data_ptr() + a * leaf.stride(0) * leaf.element_size()
            assert part.data_ptr() == begin


def test_unequal_segments_are_refused():
    cfg = LM_CONFIGS["qwen3-smoke"]
    params, _, period = _lm(cfg)
    with pytest.raises(AssertionError, match="equal segment lengths"):
        split_lm_params_for_stages(params, cfg,
                                   PartitionPlan.mpai(cfg.num_layers, split=1),
                                   period)


def _lm_pipeline(cfg, params, plan, period, tokens, devices):
    from repro_torch.models.layers import embed
    s0, s1, _ = lm_two_stage_fns(cfg, plan)
    stages = split_lm_params_for_stages(params, cfg, plan, period)
    x = embed(params["embed"], tokens,
              plan.embed_policy.precision.compute_dtype)
    n, S = tokens.shape
    got = pipeline_apply(devices, (s0, s1), stages, x[:, None],
                         hidden_shape=(1, S, cfg.d_model),
                         out_shape=(1, S, cfg.vocab_size))
    seq = torch.stack([s1(s0(x[m:m + 1].to(torch.bfloat16), stages[0]),
                          stages[1]) for m in range(n)])
    return got, seq


@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_lm_stages_compose_to_the_monolithic_forward(name):
    cfg = LM_CONFIGS[name]
    params, plan, period = _lm(cfg)
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12)), dtype=torch.int32)
    got, seq = _lm_pipeline(cfg, params, plan, period, tokens, ["cpu"] * 2)
    assert torch.equal(got, seq)
    for m in range(tokens.shape[0]):
        mono = T.forward(params, cfg, tokens[m:m + 1], plan=plan).logits
        assert torch.equal(got[m], mono.float())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("num_stages,n_micro", SCHEDULES)
def test_schedule_equals_sequential_on_card(card, num_stages, n_micro):
    got, seq = _port(num_stages, n_micro, device=card)
    torch.cuda.synchronize()
    assert torch.equal(got, seq)
    cpu, _ = _port(num_stages, n_micro)
    assert float((got.cpu() - cpu).abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LM_CONFIGS))
def test_lm_stages_on_two_streams_equal_sequential_on_card(card, name):
    cfg = LM_CONFIGS[name]
    params, plan, period = _lm(cfg)
    params = tree_map(lambda a: a.to(card), params)
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)), dtype=torch.int32, device=card)
    got, seq = _lm_pipeline(cfg, params, plan, period, tokens, [card] * 2)
    torch.cuda.synchronize()
    assert torch.equal(got, seq)


if __name__ == "__main__":
    _reference(sys.argv[1])
