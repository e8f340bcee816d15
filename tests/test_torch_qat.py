"""Partition-aware training on the port: fake quantization with a
straight-through gradient (``core.quantization.fake_quant``, ``pdot``'s
fake mode, MoE experts under a fake policy), the LM losses
(``layers.cross_entropy``, ``transformer.loss_fn``) and their gradients
against ``jax.grad``, the plan conversions, and Table I's claim run on the
port alone (``tests/test_pose_qat.py``'s three assertions, config, steps
and bars).

The reference runs jitted in a subprocess with XLA's excess precision off
(``test_torch_model.py``).  ``fake_quant``'s forward is bit-equal, in f32
and bf16; its value is the int8 round trip ``dq`` and its gradient the
identity.  The LM loss is an f32 mean over bf16 logits: within 2 bf16
ulps of itself; its gradients within 2e-2 of the global norm and of each
leaf's L2 norm (one flipped activation code of an int8 segment moves whole
leaves, as ``test_torch_pose.py`` measures for UrsoNet).  MoE experts under
a fake policy: within one bf16 ulp of the largest output, 95% identical, as
``test_torch_moe.py`` holds the other policies.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch import pose as tpose
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.tiny import TINY
from repro_torch.core import qat as tqat
from repro_torch.core import quantization as tq
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.tree import tree_map
from repro_torch.models import cnn as tcnn
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
FQ_CASES = [((7, 33), None), ((64, 48), -1), ((2, 5, 32), None),
            ((3, 3, 8, 16), -1)]
LM_PLANS = ("bf16", "mpai")
LM_B, LM_S = 2, 8
MOE_KW, MOE_B, MOE_S, MOE_D = (dict(num_experts=8, top_k=2, d_ff_expert=48),
                               3, 40, 32)
# tests/test_pose_qat.py's model and schedule
CFG = tcnn.UrsoNetConfig(name="test", image_hw=(48, 64), widths=(8, 16),
                         blocks_per_stage=1, fc_dim=32)


def _fq_x(shape):
    rng = np.random.default_rng(sum(shape))
    return (rng.normal(size=shape) * rng.uniform(0.1, 8)).astype(np.float32)


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, TINY.vocab_size, (LM_B, LM_S)).astype(np.int32)


def _moe_x():
    return np.random.default_rng(31).normal(
        size=(MOE_B, MOE_S, MOE_D)).astype(np.float32)


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread: the suite runs files in parallel
    workers, and a training loop on every core of a shared machine stalls
    them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_qat.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoE
    from repro.core import qat
    from repro.core import quantization as jq
    from repro.core.partition import PartitionPlan
    from repro.core.precision import PrecisionPolicy
    from repro.models import moe as M
    from repro.models import transformer as T
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    res = {}
    for shape, axis in FQ_CASES:
        for dtype in ("float32", "bfloat16"):
            x = jnp.asarray(_fq_x(shape)).astype(dtype)
            out = jax.jit(lambda a: jq.fake_quant(a, axis))(x)
            res[f"fq/{shape}/{dtype}"] = np.asarray(out.astype(jnp.float32))
    x = jnp.asarray(_fq_x((4, 6, 32))).astype(jnp.bfloat16)
    w = jnp.asarray(_fq_x((32, 24)))
    res["pdot"] = np.asarray(jax.jit(lambda a, b: jq.pdot(
        a, b, PrecisionPolicy.int8_qat()))(x, w).astype(jnp.float32))

    moe = JMoE(**MOE_KW)
    mparams = M.moe_init(jax.random.PRNGKey(3), MOE_D, moe, True)
    _flatten(mparams, "moe/params", res)
    fn = functools.partial(M.moe_apply, moe=moe, act="silu", glu=True,
                           policy=PrecisionPolicy.int8_qat())
    xm = jnp.asarray(_moe_x()).astype(jnp.bfloat16)
    out, aux = jax.jit(fn)(mparams, x=xm)
    res["moe/out"] = np.asarray(out.astype(jnp.float32))
    res["moe/aux"] = np.asarray(aux)
    g = jax.jit(jax.grad(lambda p: jnp.sum(
        fn(p, x=xm)[0].astype(jnp.float32) ** 2)))(mparams)
    _flatten(g, "moe/grad", res)

    cfg = tiny_dense()
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    _flatten(params, "lm/params", res)
    toks, labels = jnp.asarray(_tokens(0)), jnp.asarray(_tokens(1))
    for pname in LM_PLANS:
        plan = (qat.train_plan(PartitionPlan.mpai(cfg.num_layers))
                if pname == "mpai" else None)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: T.loss_fn(p, cfg, toks, labels, plan)))(params)
        res[f"lm/{pname}/loss"] = np.asarray(loss)
        _flatten(grads, f"lm/{pname}/grad", res)
        logits = jax.jit(lambda p: T.forward(p, cfg, toks, plan).logits)(
            params)
        res[f"lm/{pname}/logits"] = np.asarray(logits.astype(jnp.float32))
        res[f"lm/{pname}/ce"] = np.asarray(jax.jit(
            T.cross_entropy)(logits, labels))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("qat_ref") / "ref.npz"
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


# ---------------------------------------------------------------------------
# fake quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape,axis", FQ_CASES,
                         ids=[f"{s}-{a}" for s, a in FQ_CASES])
def test_fake_quant_forward_is_bit_equal(ref, shape, axis, dtype):
    x = torch.from_numpy(_fq_x(shape)).to(getattr(torch, dtype))
    out = tq.fake_quant(x, axis)
    assert out.dtype == x.dtype and out.shape == x.shape
    np.testing.assert_array_equal(_f32(out), ref[f"fq/{shape}/{dtype}"])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("axis", (None, -1))
def test_fake_quant_gradient_is_the_identity(axis, dtype):
    x = torch.from_numpy(_fq_x((16, 24))).to(getattr(torch, dtype))
    x.requires_grad_(True)
    g = torch.from_numpy(_fq_x((16, 24)) + 0.5).to(x.dtype)
    (gx,) = torch.autograd.grad(tq.fake_quant(x, axis), x, g)
    assert torch.equal(gx, g)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_fake_quant_forward_is_the_round_trip(dtype):
    """``x + (dq - x)`` is ``dq`` in either dtype: a nonzero ``dq`` lies
    within a factor of 2 of ``x``, so the difference is exact (Sterbenz),
    and a zero one gives ``x - x``."""
    x = torch.from_numpy(_fq_x((64, 48))).to(getattr(torch, dtype))
    for axis in (None, -1):
        dq = tq.quantize(x, axis).dequantize(torch.float32).to(x.dtype)
        assert torch.equal(tq.fake_quant(x, axis), dq)


def test_pdot_fake_equals_the_reference(ref):
    x = torch.from_numpy(_fq_x((4, 6, 32))).bfloat16()
    w = torch.from_numpy(_fq_x((32, 24)))
    out = tq.pdot(x, w, TPolicy.int8_qat())
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(out), ref["pdot"])


def test_pdot_fake_passes_the_gradient_straight_through():
    x = torch.from_numpy(_fq_x((5, 32))).requires_grad_(True)
    w = torch.from_numpy(_fq_x((32, 8))).requires_grad_(True)
    g = torch.from_numpy(_fq_x((5, 8)))
    gx, gw = torch.autograd.grad(
        tq.pdot(x, w, TPolicy.int8_qat()).float(), (x, w), g)
    # the straight-through estimator: the gradient of the bf16 product of
    # the fake-quantized operands, passed to the f32 operands unchanged
    xq = tq.fake_quant(x.detach()).bfloat16().float()
    wq = tq.fake_quant(w.detach(), -1).bfloat16().float()
    gb = g.bfloat16().float()
    np.testing.assert_allclose(gx.numpy(), (gb @ wq.T).bfloat16().float(),
                               rtol=2 ** -7)
    np.testing.assert_allclose(gw.numpy(), (xq.T @ gb).bfloat16().float(),
                               rtol=2 ** -7)


def test_plan_conversions_equal_the_reference():
    from repro.core import qat as jqat
    from repro.core.partition import PartitionPlan as JPlan

    def desc(plan):
        return [(s.name, s.start, s.end, s.policy.precision.value,
                 s.policy.mode, s.policy.use_pallas, s.accelerator)
                for s in plan.segments] + [
            (p.precision.value, p.mode) for p in (plan.embed_policy,
                                                  plan.head_policy)]
    for n in (2, 8, 40):
        for conv in ("train_plan", "baseline_plan"):
            assert desc(getattr(tqat, conv)(TPlan.mpai(n))) == \
                desc(getattr(jqat, conv)(JPlan.mpai(n))), (n, conv)
    assert all(s.policy.mode == "fake"
               for s in tqat.train_plan(TPlan.mpai(8)).segments
               if s.policy.precision.is_quantized)


# ---------------------------------------------------------------------------
# MoE experts under a fake policy
# ---------------------------------------------------------------------------
def test_moe_fake_experts_equal_the_reference(ref):
    moe = MoEConfig(**MOE_KW)
    p = bridge.to_torch(_unflatten(ref, "moe/params"), "cpu")
    x = torch.from_numpy(_moe_x()).bfloat16()
    out, aux = TMoE.moe_apply(p, moe, x, "silu", True, TPolicy.int8_qat())
    want = ref["moe/out"]
    got = _f32(out)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)
    assert (got == want).mean() >= 0.95, (got == want).mean()
    np.testing.assert_allclose(aux.numpy(), ref["moe/aux"], rtol=1e-6)


def test_moe_fake_expert_gradients_equal_jax_grad(ref):
    moe = MoEConfig(**MOE_KW)
    p = tree_map(lambda t: t.requires_grad_(True),
                 bridge.to_torch(_unflatten(ref, "moe/params"), "cpu"))
    x = torch.from_numpy(_moe_x()).bfloat16()
    out, _ = TMoE.moe_apply(p, moe, x, "silu", True, TPolicy.int8_qat())
    torch.sum(out.float() ** 2).backward()
    want = _unflatten(ref, "moe/grad")
    for k in want:
        g, w = _f32(p[k].grad), want[k]
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= 2e-2, (k, err)


# ---------------------------------------------------------------------------
# LM losses and gradients
# ---------------------------------------------------------------------------
def _lm_plan(pname):
    return (tqat.train_plan(TPlan.mpai(TINY.num_layers))
            if pname == "mpai" else None)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(abs(float(x)))) - 7)


@pytest.mark.parametrize("pname", LM_PLANS)
def test_cross_entropy_equals_the_reference(ref, pname):
    logits = torch.from_numpy(ref[f"lm/{pname}/logits"]).bfloat16()
    got = TL.cross_entropy(logits, torch.from_numpy(_tokens(1)))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), ref[f"lm/{pname}/ce"], rtol=1e-6)


@pytest.mark.parametrize("pname", LM_PLANS)
def test_loss_fn_and_gradients_equal_jax_grad(ref, pname):
    params = tree_map(lambda t: t.requires_grad_(True), bridge.to_torch(
        _unflatten(ref, "lm/params"), "cpu"))
    loss = TT.loss_fn(params, TINY, torch.from_numpy(_tokens(0)),
                      torch.from_numpy(_tokens(1)), _lm_plan(pname))
    want = float(ref[f"lm/{pname}/loss"])
    assert abs(float(loss) - want) <= 2 * _bf16_ulp(want)
    loss.backward()
    got, want_g = {}, {}
    _flatten(tree_map(lambda t: t.grad, params), "", got)
    _flatten(_unflatten(ref, f"lm/{pname}/grad"), "", want_g)
    assert sorted(got) == sorted(want_g)
    norm = lambda g: np.sqrt(sum(float(np.sum(np.square(_f32(v))))
                                 for v in g.values()))
    np.testing.assert_allclose(norm(got), norm(want_g), rtol=2e-2)
    for k in want_g:
        g, w = _f32(got[k]), want_g[k]
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= 2e-2, (k, err)


@pytest.mark.parametrize("kernel", ["wkv", "selective_scan"])
def test_kernels_carry_a_gradient_through_their_autograd_functions(kernel):
    """On CPU tensors ``wkv`` and ``selective_scan`` differentiate through
    ``WKVFn`` / ``SelectiveScanFn`` (their plain backwards, the CPU side of
    the backward kernels) to the gradient of autograd through the plain
    forward; without a gradient they take the plain forward alone."""
    from repro_torch.kernels import selective_scan as tss
    from repro_torch.kernels import wkv as twkv
    rng = np.random.default_rng(7)
    mk = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    if kernel == "wkv":
        args = [mk(2, 9, 2, 8) for _ in range(3)]
        args += [torch.exp(-torch.exp(mk(2, 9, 2, 8) - 2)), mk(2, 8)]
        fn, plain, cls = twkv.wkv, twkv.wkv_plain, twkv.WKVFn
    else:
        args = [mk(2, 9, 6), torch.nn.functional.softplus(mk(2, 9, 6) - 3),
                mk(2, 9, 4), mk(2, 9, 4), -torch.rand(6, 4) * 4, mk(6)]
        fn, plain, cls = (tss.selective_scan, tss.selective_scan_plain,
                          tss.SelectiveScanFn)
    grads = []
    for f in (fn, plain):
        leaves = [t.clone().requires_grad_(True) for t in args]
        y, state = f(*leaves)
        if f is fn:
            assert type(y.grad_fn).__name__ == f"{cls.__name__}Backward"
        (y.square().sum() + state.sum()).backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(want)
    with torch.no_grad():
        y, _ = fn(*[t.clone().requires_grad_(True) for t in args])
    assert y.grad_fn is None


def test_loss_fn_refuses_frontend_embeds():
    """Frontends are ported: ``loss_fn`` no longer refuses embeddings, it
    skips their positions (``tests/test_torch_frontends.py`` holds it to
    the reference)."""
    params = TT.model_init(TINY, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    fe = torch.zeros(1, 2, TINY.d_model)
    loss = TT.loss_fn(params, TINY, toks, toks, frontend_embeds=fe)
    logits = TT.forward(params, TINY, toks, frontend_embeds=fe).logits
    assert logits.shape[1] == 6
    assert torch.equal(loss, TL.cross_entropy(logits[:, -4:], toks))


# ---------------------------------------------------------------------------
# Table I's claim on the port alone (tests/test_pose_qat.py)
# ---------------------------------------------------------------------------
def _score(m):
    return m[0] + m[1] / 100          # LOCE + ORIE blend


@pytest.fixture(scope="module")
def fp32_trained():
    return tpose.train_ursonet(CFG, TPolicy.bf16(), TPolicy.fp32(),
                               steps=250, batch=16, device="cpu")


def test_training_reduces_loss(fp32_trained):
    _, hist = fp32_trained
    assert hist[-1][1] < hist[0][1] * 0.7, hist


def test_int8_serving_of_fp32_model_changes_outputs(fp32_trained):
    params, _ = fp32_trained
    base = tpose.eval_ursonet(params, CFG, TPolicy.bf16(), TPolicy.fp32(),
                              batches=4, device="cpu")
    ptq = tpose.eval_ursonet(params, CFG, TPolicy.int8(), TPolicy.int8(),
                             batches=4, device="cpu")
    assert abs(_score(ptq) - _score(base)) > 1e-4     # int8 changed outputs
    assert _score(ptq) > _score(base) - 0.3           # and is no free lunch


def test_mpai_partition_close_to_baseline(fp32_trained):
    params_fp32, _ = fp32_trained
    base = tpose.eval_ursonet(params_fp32, CFG, TPolicy.bf16(),
                              TPolicy.fp32(), batches=4, device="cpu")
    ptq = tpose.eval_ursonet(params_fp32, CFG, TPolicy.int8(),
                             TPolicy.int8(), batches=4, device="cpu")
    params_mpai, _ = tpose.train_ursonet(CFG, TPolicy.int8_qat(),
                                         TPolicy.bf16(), steps=250, batch=16,
                                         device="cpu")
    mpai = tpose.eval_ursonet(params_mpai, CFG, TPolicy.int8(),
                              TPolicy.bf16(), batches=4, device="cpu")
    assert _score(mpai) <= _score(ptq) + 0.05
    assert _score(mpai) <= _score(base) * 1.5 + 0.1


def test_run_condition_reports_the_table_i_row():
    row = tpose.run_condition("int8_qat", CFG, steps=3, batch=4,
                              device="cpu")
    assert set(row) == {"condition", "loce", "orie", "final_train_loss"}
    assert row["condition"] == "int8_qat"
    assert all(np.isfinite(row[k]) for k in ("loce", "orie",
                                              "final_train_loss"))
    assert sorted(tpose.POLICIES) == ["fp32", "int8_ptq", "int8_qat", "mpai"]


if __name__ == "__main__":
    _reference(sys.argv[1])
