"""LM training on the port against the reference: the data stream
(``lm_batch``, ``prng.randint`` / ``bernoulli``), ``loss_fn`` and its
gradients under the f32, bf16 and fake-quant ``"mpai"`` plans, three
``make_step_fn`` steps with ``grad_accum`` 1 and 2, the plans and
``quantization_error``, the flash kernel's plain backward against
``jax.grad`` of ``full_attention``, the elastic meshes and the data tests
of ``tests/test_runtime.py``; and, on the card (``cuda``), the backward
kernel against its plain version and one bf16 train step against the CPU.

The reference runs jitted in a subprocess with XLA's excess precision off
(``test_torch_model.py``); its ``Trainer`` fails on jax 0.9 (ROADMAP.md
queue 3), so the step is ``jax.jit(make_step_fn(cfg, tc, plan, 1))`` with
no mesh.  Tolerances: the f32 loss within 1e-6 relative and its gradients
within 1e-4 of each leaf's L2 norm; bf16 and "mpai" within 2e-2 of each
leaf's L2 norm (``test_torch_qat.py``).  After three AdamW steps (``STEP_
TOL``) the f32 parameters agree within 1e-3 (1e-6 on average); the bf16
ones within ``2.2 * lr`` a step (a near-zero gradient's sign can flip,
and an early Adam step is ``+-lr`` whatever its size: the bound of
``tests/test_runtime.py``'s grad-accumulation test) and 2e-3 on average.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.base import (MeshConfig as TMesh,
                                      ShapeConfig as TShape,
                                      TrainConfig as TTrain)
from repro_torch.configs.tiny import TINY
from repro_torch.core import prng
from repro_torch.core import qat as tqat
from repro_torch.core import quantization as tq
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.core.partition import default_plan as t_default_plan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import train_loop as ttrain

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("f32", "bf16", "mpai")
B, S = 4, 16
TC_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50,
             checkpoint_every=5, seed=0)
STEPS = 3
ACCUM = (1, 2)
STEP_CASES = [(p, ga) for p in ("f32", "bf16") for ga in ACCUM]
FA_SHAPE = (2, 37, 2, 3, 16)          # B, S, KVp, gp, hd
QE_CASES = [((7, 33), None), ((64, 48), -1), ((3, 5, 32), 0)]
LM_CASES = [(256, 32, 4), (100352, 257, 3), (7, 50, 2), (1, 9, 2)]
RANDINT_BOUNDS = [(0, 100352), (-5, 7), (3, 3), (10, 2), (0, 2 ** 31 - 1),
                  (-2 ** 31, 2 ** 31 - 1), (0, 65536), (0, 65537)]


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


def _fa_inputs():
    rng = np.random.default_rng(17)
    b, s, kvp, gp, hd = FA_SHAPE
    q = rng.normal(size=(b, s, kvp, gp, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kvp, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kvp, hd)).astype(np.float32)
    do = rng.normal(size=(b, s, kvp, gp, hd)).astype(np.float32)
    return q, k, v, do


def _qe_x(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    return (rng.normal(size=shape) * rng.uniform(0.1, 8)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_train.py OUT.npz``
# ---------------------------------------------------------------------------
def _ref_plan(pname, cfg):
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.core.precision import PrecisionPolicy
    if pname == "f32":
        return PartitionPlan.uniform(cfg.num_layers, PrecisionPolicy.fp32())
    if pname == "mpai":
        return qat.train_plan(PartitionPlan.mpai(cfg.num_layers))
    return None


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.core import quantization as jq
    from repro.data.pipeline import lm_batch
    from repro.models import attention as JA
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.runtime.train_loop import TrainState, make_step_fn
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    res = {}
    cfg = tiny_dense()
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    _flatten(params, "lm/params", res)
    shape = ShapeConfig("t", S, B, "train")
    batch = lm_batch(cfg, shape, 0)
    for pname in PLANS:
        plan = _ref_plan(pname, cfg)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: T.loss_fn(p, cfg, batch["tokens"], batch["labels"],
                                plan)))(params)
        res[f"lm/{pname}/loss"] = np.asarray(loss)
        _flatten(grads, f"lm/{pname}/grad", res)

    tc = TrainConfig(**TC_KW)
    for pname, ga in STEP_CASES:
        c = tiny_dense(grad_accum=ga)
        step = jax.jit(make_step_fn(c, tc, _ref_plan(pname, c), 1))
        state = TrainState(params, adamw.init(params, jnp.float32),
                           jnp.zeros((), jnp.int32))
        for s in range(STEPS):
            state, m = step(state, lm_batch(c, shape, s))
            res[f"step/{pname}/{ga}/{s}/loss"] = np.asarray(m["loss"])
            res[f"step/{pname}/{ga}/{s}/grad_norm"] = np.asarray(
                m["grad_norm"])
        _flatten(state.params, f"step/{pname}/{ga}/params", res)

    q, k, v, do = map(jnp.asarray, _fa_inputs())
    pos = jnp.arange(FA_SHAPE[1], dtype=jnp.int32)
    _, vjp = jax.vjp(lambda a, b, c: JA.full_attention(a, b, c, pos, pos),
                     q, k, v)
    for name, g in zip(("dq", "dk", "dv"), vjp(do)):
        res[f"fa/{name}"] = np.asarray(g)

    for shape_, axis in QE_CASES:
        res[f"qe/{shape_}/{axis}"] = np.asarray(jax.jit(
            lambda a: jq.quantization_error(a, axis))(jnp.asarray(
                _qe_x(shape_))))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_ref") / "ref.npz"
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


def _port_plan(pname):
    if pname == "f32":
        return TPlan.uniform(TINY.num_layers, TPolicy.fp32())
    if pname == "mpai":
        return tqat.train_plan(TPlan.mpai(TINY.num_layers))
    return None


def _batch(cfg=TINY, step=0):
    return tpipe.lm_batch(cfg, TShape("t", S, B, "train"), step,
                          device="cpu")


def _leaf_errs(got, want):
    return {k: float(np.linalg.norm(_f32(got[k]) - want[k])
                     / np.linalg.norm(want[k])) for k in want}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch", LM_CASES,
                         ids=[f"v{v}-s{s}-b{b}" for v, s, b in LM_CASES])
def test_lm_batch_is_bit_equal_to_the_reference(vocab, seq, batch):
    import sys as _sys
    _sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense
    from repro.configs.base import ShapeConfig
    from repro.data.pipeline import lm_batch
    cfg = tiny_dense(vocab_size=vocab)
    for step, seed in ((0, 0), (5, 3), (123, 0)):
        want = lm_batch(cfg, ShapeConfig("t", seq, batch, "train"), step,
                        seed=seed)
        got = tpipe.lm_batch(TINY.with_(vocab_size=vocab),
                             TShape("t", seq, batch, "train"), step,
                             seed=seed, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("lo,hi", RANDINT_BOUNDS,
                         ids=[f"{lo}:{hi}" for lo, hi in RANDINT_BOUNDS])
def test_randint_is_bit_equal_to_jax(lo, hi):
    import jax
    for seed in (0, 11, -3):
        want = jax.random.randint(jax.random.PRNGKey(seed), (3, 333), lo, hi)
        got = prng.randint(prng.threefry_seed(torch.tensor(seed)), (3, 333),
                           lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p", (0.1, 0.5, 0.999, 1e-3))
def test_bernoulli_is_bit_equal_to_jax(p):
    import jax
    for seed in (0, 7):
        want = jax.random.bernoulli(jax.random.PRNGKey(seed), p, (40, 50))
        got = prng.bernoulli(prng.threefry_seed(torch.tensor(seed)), p,
                             (40, 50))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestData:
    SHAPE = TShape("t", 32, 4, "train")

    def test_lm_batch_deterministic(self):
        b1 = tpipe.lm_batch(TINY, self.SHAPE, 5, device="cpu")
        b2 = tpipe.lm_batch(TINY, self.SHAPE, 5, device="cpu")
        assert torch.equal(b1["tokens"], b2["tokens"])
        b3 = tpipe.lm_batch(TINY, self.SHAPE, 6, device="cpu")
        assert not torch.equal(b1["tokens"], b3["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = tpipe.lm_batch(TINY, self.SHAPE, 0, device="cpu")
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharded_stream_partitions_batch(self):
        mk = lambda step: tpipe.lm_batch(TINY, self.SHAPE, step, device="cpu")
        parts = [tpipe.HostShardedStream(mk, self.SHAPE.global_batch, h, 2)(3)
                 for h in range(2)]
        rebuilt = torch.cat([p["tokens"] for p in parts])
        assert torch.equal(rebuilt, mk(3)["tokens"])
        with pytest.raises(ValueError, match="split"):
            tpipe.HostShardedStream(mk, 5, 0, 2)

    def test_pose_batch_shapes_and_quat_norm(self):
        b = tpipe.pose_batch(4, 0, device="cpu")
        assert b["images"].shape == (4, 96, 128, 3)
        np.testing.assert_allclose(torch.linalg.norm(b["quat"], dim=-1),
                                   1.0, atol=1e-5)

    def test_lm_batch_specs_are_meta(self):
        specs = tpipe.lm_batch_specs(TINY, self.SHAPE)
        assert sorted(specs) == ["labels", "tokens"]
        for t in specs.values():
            assert t.device.type == "meta" and t.dtype == torch.int32
            assert tuple(t.shape) == (4, 32)
        assert sorted(tpipe.lm_batch_specs(TINY, self.SHAPE, train=False)) \
            == ["tokens"]


def test_shapes_and_meshes_equal_the_reference():
    from repro.configs import base as jb
    from repro_torch.configs import base as tb
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        j, t = getattr(jb, name), getattr(tb, name)
        assert (t.name, t.seq_len, t.global_batch, t.kind, t.tokens) == \
            (j.name, j.seq_len, j.global_batch, j.kind, j.tokens)
    assert sorted(tb.SHAPES) == sorted(jb.SHAPES)
    for name in ("SINGLE_POD", "MULTI_POD", "SMOKE_MESH"):
        j, t = getattr(jb, name), getattr(tb, name)
        assert (t.shape, t.axes, t.num_devices, t.tp, t.dp) == \
            (j.shape, j.axes, j.num_devices, j.tp, j.dp)


# ---------------------------------------------------------------------------
# plans and quantization_error
# ---------------------------------------------------------------------------
def _desc(plan):
    return [(s.name, s.start, s.end, s.policy.precision.value,
             s.policy.mode, s.policy.use_pallas, s.accelerator)
            for s in plan.segments] + [
        (p.precision.value, p.mode) for p in (plan.embed_policy,
                                              plan.head_policy)]


@pytest.mark.parametrize("n", (1, 8, 40))
def test_int8_all_and_default_plan_equal_the_reference(n):
    from repro.core.partition import PartitionPlan as JPlan
    from repro.core.partition import default_plan
    for kw in ({}, {"mode": "fake"}, {"use_pallas": True}):
        assert _desc(TPlan.int8_all(n, **kw)) == _desc(JPlan.int8_all(n, **kw))
    assert _desc(t_default_plan(n)) == _desc(default_plan(n))


@pytest.mark.parametrize("shape,axis", QE_CASES,
                         ids=[f"{s}-{a}" for s, a in QE_CASES])
def test_quantization_error_equals_the_reference(ref, shape, axis):
    x = torch.from_numpy(_qe_x(shape))
    got = tq.quantization_error(x, axis)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(ref[f"qe/{shape}/{axis}"])
    scale = tq.quantize(x, axis).scale
    assert float(got) <= float(scale.max()) / 2 * (1 + 1e-6)


# ---------------------------------------------------------------------------
# losses, gradients and steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pname", PLANS)
def test_loss_fn_and_gradients_equal_jax_grad(ref, pname):
    params = tree_map(lambda t: t.requires_grad_(True), bridge.to_torch(
        _unflatten(ref, "lm/params"), "cpu"))
    batch = _batch()
    loss = TT.loss_fn(params, TINY, batch["tokens"], batch["labels"],
                      _port_plan(pname))
    want = float(ref[f"lm/{pname}/loss"])
    rtol = 1e-6 if pname == "f32" else 2 ** -7
    assert abs(float(loss.detach()) - want) <= rtol * abs(want)
    loss.backward()
    got, want_g = {}, {}
    _flatten(tree_map(lambda t: t.grad, params), "", got)
    _flatten(_unflatten(ref, f"lm/{pname}/grad"), "", want_g)
    assert sorted(got) == sorted(want_g)
    tol = 1e-4 if pname == "f32" else 2e-2
    errs = _leaf_errs(got, want_g)
    assert max(errs.values()) <= tol, errs


# (loss rtol, grad-norm rtol, max |param diff|, mean |param diff|) after
# three steps: f32 as measured x 10+ (6e-5 and 7e-8 at worst); bf16 Adam
# noise (an early step is +-lr a weight) within 2.2 * lr a step and 2e-3 on
# average (8e-4 measured)
STEP_TOL = {"f32": (1e-6, 1e-5, 1e-3, 1e-6),
            "bf16": (2 ** -7, 5e-2, 2.2 * TC_KW["learning_rate"] * STEPS,
                     2e-3)}


@pytest.mark.parametrize("pname,ga", STEP_CASES,
                         ids=[f"{p}-ga{g}" for p, g in STEP_CASES])
def test_three_steps_equal_the_reference(ref, pname, ga):
    cfg = TINY.with_(grad_accum=ga)
    tc = TTrain(**TC_KW)
    params = bridge.to_torch(_unflatten(ref, "lm/params"), "cpu")
    state = ttrain.TrainState(params, tadamw.init(params),
                              torch.zeros((), dtype=torch.int32))
    step = ttrain.make_step_fn(cfg, tc, _port_plan(pname), 1)
    l_tol, n_tol, max_tol, mean_tol = STEP_TOL[pname]
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        want_l = float(ref[f"step/{pname}/{ga}/{s}/loss"])
        want_n = float(ref[f"step/{pname}/{ga}/{s}/grad_norm"])
        assert abs(float(m["loss"]) - want_l) <= l_tol * want_l, s
        assert abs(float(m["grad_norm"]) - want_n) <= n_tol * want_n, s
    assert int(state.step) == STEPS
    got, want = {}, {}
    _flatten(state.params, "", got)
    _flatten(_unflatten(ref, f"step/{pname}/{ga}/params"), "", want)
    assert sorted(got) == sorted(want)
    for k in want:
        d = np.abs(_f32(got[k]) - want[k])
        assert d.max() <= max_tol, (k, d.max())
        assert d.mean() <= mean_tol, (k, d.mean())


def test_grad_accum_matches_single_batch():
    """``tests/test_runtime.py``'s grad-accumulation test on the port."""
    tc = TTrain(**TC_KW)
    params = TT.model_init(TINY, torch.Generator().manual_seed(0), "cpu")
    batch = tpipe.lm_batch(TINY, TShape("t", 32, 4, "train"), 0,
                           device="cpu")
    out = []
    for ga in ACCUM:
        state = ttrain.TrainState(params, tadamw.init(params),
                                  torch.zeros((), dtype=torch.int32))
        out.append(ttrain.make_step_fn(TINY.with_(grad_accum=ga), tc, None,
                                       1)(state, batch))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-3)
    for a, b in zip(tree_leaves(s1.params),
                    tree_leaves(s2.params)):
        d = (a - b).abs()
        assert float(d.max()) <= 2.2 * tc.learning_rate
        assert float(d.mean()) < 1e-4


def test_trainer_loss_decreases():
    """``tests/test_runtime.py``'s first trainer test on the port."""
    tr = ttrain.Trainer(TINY, TShape("t", 32, 4, "train"),
                        TMesh((1, 1), ("data", "model")), TTrain(**TC_KW),
                        device="cpu")
    state = tr.init_state()
    data = lambda s: tpipe.lm_batch(TINY, tr.shape, s, device="cpu")
    state, hist = tr.run(state, data, 30, log_every=1)
    assert [h["step"] for h in hist] == list(range(1, 31))
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first - 0.3, (first, last)


@pytest.mark.parametrize("mesh", [((2, 1), ("data", "model")),
                                  ((1, 2), ("data", "model")),
                                  ((2, 16, 16), ("pod", "data", "model"))])
def test_trainer_refuses_a_mesh_of_many_devices(mesh):
    """Without as many ``torch.distributed`` ranks as the mesh has devices
    (here no process group: one device) the mesh is refused."""
    n = TMesh(*mesh).num_devices
    with pytest.raises(ValueError, match=f"need {n} devices, have 1"):
        ttrain.Trainer(TINY, TShape("t", 32, 4, "train"), TMesh(*mesh),
                       TTrain(**TC_KW), device="cpu")


def test_remat_changes_no_value():
    """``cfg.remat`` recomputes each super-block in the backward pass: the
    loss and every gradient are bit-equal without it, and with groups."""
    params = TT.model_init(TINY.with_(num_layers=4),
                           torch.Generator().manual_seed(1), "cpu")
    batch = _batch()
    out = []
    for kw in ({"remat": False}, {"remat": True},
               {"remat": True, "remat_group": 2}):
        cfg = TINY.with_(num_layers=4, **kw)
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        loss = TT.loss_fn(p, cfg, batch["tokens"], batch["labels"])
        loss.backward()
        out.append((loss.detach(), tree_leaves(
            tree_map(lambda t: t.grad, p))))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


# ---------------------------------------------------------------------------
# the flash kernel's plain backward
# ---------------------------------------------------------------------------
def test_flash_plain_backward_equals_jax_grad_of_full_attention(ref):
    q, k, v, do = map(torch.from_numpy, _fa_inputs())
    grads = tfa.flash_attention_bwd_plain(do, q, k, v)
    for name, g in zip(("dq", "dk", "dv"), grads):
        want = ref[f"fa/{name}"]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err)
    # the wrapper takes the plain version for CPU tensors; the CPU forward
    # of ``flash_attention`` differentiates to the same
    assert all(torch.equal(a, b) for a, b in zip(
        tfa.flash_attention_bwd(do, q, k, v, tfa.flash_attention_plain(
            q, k, v), None), grads))


# ---------------------------------------------------------------------------
# elastic meshes (``tests/test_runtime.py::TestElastic``)
# ---------------------------------------------------------------------------
class TestElastic:
    DEVICES = (1, 2, 3, 7, 16, 17, 100, 255, 256, 511, 4096)

    @pytest.mark.parametrize("n", DEVICES)
    def test_choose_mesh_uses_all_possible_devices(self, n):
        from repro.runtime.elastic import choose_mesh
        mc = telastic.choose_mesh(n, prefer_model=16)
        assert mc.num_devices <= n
        assert mc.tp in (1, 2, 4, 8, 16)
        assert mc.num_devices >= n // 2 or mc.num_devices == n
        want = choose_mesh(n, prefer_model=16)
        assert (mc.shape, mc.axes) == (want.shape, want.axes)

    @pytest.mark.parametrize("lost", (0, 1, 16, 200, 255))
    def test_surviving_mesh_shrinks(self, lost):
        from repro.configs.base import MeshConfig as JMesh
        from repro.runtime.elastic import surviving_mesh
        mc = telastic.surviving_mesh(TMesh((16, 16), ("data", "model")),
                                     lost)
        assert mc.num_devices <= 256 - lost
        assert mc.tp <= 16
        want = surviving_mesh(JMesh((16, 16), ("data", "model")), lost)
        assert (mc.shape, mc.axes) == (want.shape, want.axes)

    def test_no_survivor_raises(self):
        with pytest.raises(ValueError, match="no devices"):
            telastic.surviving_mesh(TMesh((2, 1), ("data", "model")), 2)


# ---------------------------------------------------------------------------
# the backward's route, and the kernels on the card
# ---------------------------------------------------------------------------
ROUTE_CASES = [(dt, hd) for dt in ("bfloat16", "float32")
               for hd in (8, 16, 32, 64, 96, 128, 256)]


@pytest.mark.parametrize("dtype,hd", ROUTE_CASES,
                         ids=[f"{d}-hd{h}" for d, h in ROUTE_CASES])
def test_backward_route_is_chosen_by_dtype_and_head_dim(dtype, hd):
    """bf16 at hd 64 and 128 (every full-size config) takes the wgmma
    kernels, any other bf16 hd the mma.sync ones, f32 the CUDA-core ones."""
    want = ("f32" if dtype == "float32"
            else "wgmma" if hd in (64, 128) else "mma_sync")
    assert tfa.bwd_route(getattr(torch, dtype), hd) == want


# (hd, gp, S, dtype): the wgmma route at hd 64 and 128 over gp 1, 4, 5 and
# 16 (tiles of 64, 64, 60 and 64 packed rows) and ragged and whole tiles;
# the mma.sync route at hd 16; the f32 route at hd 64
BWD_CASES = ([(hd, gp, s, "bfloat16") for hd in (64, 128)
              for gp in (1, 4, 5, 16) for s in (37, 256, 300)]
             + [(16, gp, s, "bfloat16") for gp in (1, 5) for s in (37, 256)]
             + [(64, gp, s, "float32") for gp in (1, 5) for s in (37, 256)])
# stated tolerances of the backward kernel against its plain version, per
# gradient: bf16 (P and dS enter their products as bf16) max |err| within
# 2**-6 of max |ref| and the Frobenius error within 2**-7; f32 within 2**-16
BWD_TOL = {"bfloat16": (2 ** -6, 2 ** -7), "float32": (2 ** -16, 2 ** -18)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hd,gp,s,dtype", BWD_CASES,
                         ids=[f"hd{h}-gp{g}-S{s}-{d}"
                              for h, g, s, d in BWD_CASES])
def test_backward_kernel_equals_its_plain_version(card, hd, gp, s, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(hd * 100000 + gp * 1000 + s)
    b, kvp = 2, 2
    mk = lambda *shape: torch.randn(shape, generator=g, device=card).to(dt)
    q, do = mk(b, s, kvp, gp, hd), mk(b, s, kvp, gp, hd)
    k, v = mk(b, s, kvp, hd), mk(b, s, kvp, hd)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    route = tfa.bwd_route(dt, hd)
    before = tfa.flash_attention_bwd.launches_by_route[route]
    out = tfa.flash_attention(qq, kk, vv)
    out.backward(do)
    assert tfa.flash_attention_bwd.launches_by_route[route] == before + 1
    want = tfa.flash_attention_bwd_plain(do, q, k, v)
    max_tol, fro_tol = BWD_TOL[dtype]
    for got, w in zip((qq.grad, kk.grad, vv.grad), want):
        err = (got.float() - w.float())
        assert torch.isfinite(got).all()
        assert err.abs().max() <= max_tol * w.float().abs().max()
        assert torch.linalg.norm(err) <= fro_tol * torch.linalg.norm(
            w.float())


@pytest.mark.cuda
@pytest.mark.parametrize("hd,gp", [(128, 5), (64, 1)],
                         ids=["hd128-gp5", "hd64-gp1"])
def test_backward_kernel_is_deterministic(card, hd, gp):
    g = torch.Generator(device=card).manual_seed(3)
    mk = lambda *shape: torch.randn(shape, generator=g,
                                    device=card).bfloat16()
    q, do, k, v = mk(1, 300, 2, gp, hd), mk(1, 300, 2, gp, hd), \
        mk(1, 300, 2, hd), mk(1, 300, 2, hd)
    runs = []
    for _ in range(2):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        tfa.flash_attention(qq, kk, vv).backward(do)
        runs.append((qq.grad, kk.grad, vv.grad))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_a_bf16_train_step_on_the_card_equals_the_cpu(card):
    """One bf16 step of ``tiny_dense``: loss within 2 bf16 ulps, every
    parameter within ``STEP_TOL["bf16"]``'s ``2.2 * lr`` and 2e-3 on
    average (the flash kernel sums in another order than the CPU's plain
    attention, and a first Adam step is +-lr a weight: 1.6e-4 measured)."""
    tc = TTrain(**TC_KW)
    shape = TShape("t", 64, 4, "train")
    states, metrics = [], []
    for dev in ("cpu", card):
        params = TT.model_init(TINY, torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda t: t.to(dev), params)
        state = ttrain.TrainState(params, tadamw.init(params),
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev))
        s, m = ttrain.make_step_fn(TINY, tc, None, 1)(
            state, tpipe.lm_batch(TINY, shape, 0, device=dev))
        states.append(s)
        metrics.append(m)
    lc, lg = float(metrics[0]["loss"]), float(metrics[1]["loss"])
    assert abs(lc - lg) <= 2 * 2 ** (np.floor(np.log2(lc)) - 7)
    for a, b in zip(tree_leaves(states[0].params),
                    tree_leaves(states[1].params)):
        d = (a - b.cpu()).abs()
        assert float(d.max()) <= 2.2 * tc.learning_rate
        assert float(d.mean()) <= STEP_TOL["bf16"][3]


if __name__ == "__main__":
    _reference(sys.argv[1])
