"""The port's precision core against the reference: int8 codes, scales,
int32 accumulators and bf16 ``pdot`` outputs are equal, bit for bit, to the
jitted JAX functions (the serving path runs them jitted); partition plans
convert the same way."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import qat as jqat
from repro.core import quantization as jq
from repro.core.partition import PartitionPlan as JPlan
from repro.core.precision import Precision as JPrecision
from repro.core.precision import PrecisionPolicy as JPolicy
from repro_torch.core import qat as tqat
from repro_torch.core import quantization as tq
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.core.precision import Precision as TPrecision
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import int8_matmul as im

RNG = np.random.default_rng(11)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32)
                      if t.dtype == jnp.bfloat16 else t)


@pytest.mark.parametrize("shape,channel_axis,batch_axes", [
    ((7, 33), None, ()),            # per tensor
    ((64, 48), -1, ()),             # per output channel (weights)
    ((3, 16, 40), -1, (0,)),        # stacked layers keep their own scales
    ((2, 5, 32), None, ()),         # activations [B, S, K]
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_codes_and_scales_equal(shape, channel_axis, batch_axes,
                                         dtype):
    x = (RNG.normal(size=shape) * RNG.uniform(0.01, 20)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.tensor(x).to(getattr(torch, dtype))
    ref = jax.jit(lambda a: jq.quantize(a, channel_axis, batch_axes))(xj)
    got = tq.quantize(xt, channel_axis, batch_axes)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def test_quantize_rounds_exact_halves_to_even():
    # absmax 127/8 makes the scale exactly 1/8, so every value below sits
    # exactly on a rounding boundary
    x = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5],
                 np.float32) / 8
    ref = jax.jit(jq.quantize)(jnp.asarray(x))
    got = tq.quantize(torch.tensor(x))
    assert float(got.scale) == 0.125
    np.testing.assert_array_equal(got.values.numpy(),
                                  [127, 0, 2, 2, 0, -2, 4, 126])
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (8, 96, 40), (24, 64, 256)])
def test_int8_accumulators_equal(m, k, n):
    x = RNG.integers(-127, 128, (m, k), dtype=np.int8)
    w = RNG.integers(-127, 128, (k, n), dtype=np.int8)
    ref = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    got = im.int8_matmul(torch.tensor(x), torch.tensor(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("lead", [(4,), (2, 8), (3, 1)])
def test_pdot_quant_bf16_outputs_equal(per_channel, lead):
    k, n = 64, 96
    x = (RNG.normal(size=lead + (k,)) * RNG.uniform(0.1, 5)).astype(np.float32)
    w = (RNG.normal(size=(k, n)) / 8).astype(np.float32)
    jpol = JPolicy(JPrecision.INT8, "quant", per_channel=per_channel)
    tpol = TPolicy(TPrecision.INT8, "quant", per_channel=per_channel)
    ref = jax.jit(lambda a, b: jq.pdot(a, b, jpol))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    got = tq.pdot(torch.tensor(x).bfloat16(), torch.tensor(w), tpol)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(ref))
    # a pre-quantized weight gives the same product as quantizing at use
    wq = tq.quantize(torch.tensor(w), channel_axis=-1 if per_channel else None)
    np.testing.assert_array_equal(
        _np(tq.pdot(torch.tensor(x).bfloat16(), wq, tpol)), _np(ref))


@pytest.mark.parametrize("policy", ["bf16", "fp32"])
def test_pdot_raw_equal(policy):
    x = RNG.normal(size=(3, 5, 32)).astype(np.float32)
    w = (RNG.normal(size=(32, 48)) / 6).astype(np.float32)
    ref = jax.jit(lambda a, b: jq.pdot(a, b, getattr(JPolicy, policy)()))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    got = tq.pdot(torch.tensor(x).bfloat16(), torch.tensor(w),
                  getattr(TPolicy, policy)())
    np.testing.assert_array_equal(_np(got), _np(ref))
    # raw segments dequantize a pre-quantized weight first
    refq = jax.jit(lambda a, b: jq.pdot(a, jq.quantize(b, -1),
                                        getattr(JPolicy, policy)()))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    gotq = tq.pdot(torch.tensor(x).bfloat16(),
                   tq.quantize(torch.tensor(w), -1), getattr(TPolicy, policy)())
    np.testing.assert_array_equal(_np(gotq), _np(refq))


def test_pdot_fake_mode_is_not_ported():
    """Fake mode (QAT) is ported now: on f32 activations it equals the
    jitted reference bit for bit (bf16 activations are held in
    ``test_torch_qat.py``, against a reference without excess precision)."""
    x = RNG.normal(size=(3, 5, 32)).astype(np.float32)
    w = (RNG.normal(size=(32, 48)) / 6).astype(np.float32)
    ref = jax.jit(lambda a, b: jq.pdot(a, b, JPolicy.int8_qat()))(
        jnp.asarray(x), jnp.asarray(w))
    got = tq.pdot(torch.tensor(x), torch.tensor(w), TPolicy.int8_qat())
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_quantize_params_stacked_equal():
    tree = {"w": RNG.normal(size=(3, 16, 24)).astype(np.float32),
            "norm": {"scale": np.ones((3, 16), np.float32)},
            "v": RNG.normal(size=(16,)).astype(np.float32)}
    ref = jax.jit(lambda t: jq.quantize_params(t, stacked=True))(
        jax.tree.map(jnp.asarray, tree))
    got = tq.quantize_params(jax.tree.map(torch.tensor, tree), stacked=True)
    np.testing.assert_array_equal(got["w"].values.numpy(),
                                  np.asarray(ref["w"].values))
    np.testing.assert_array_equal(got["w"].scale.numpy(),
                                  np.asarray(ref["w"].scale))
    # 2-D stacked norms quantize too (ndim >= 2), vectors stay float
    np.testing.assert_array_equal(got["norm"]["scale"].values.numpy(),
                                  np.asarray(ref["norm"]["scale"].values))
    assert isinstance(got["v"], torch.Tensor)


def _plan_fields(plan):
    seg = lambda s: (s.name, s.start, s.end, s.policy.precision.value,
                     s.policy.mode, s.policy.per_channel,
                     s.policy.use_pallas, s.accelerator)
    pol = lambda p: (p.precision.value, p.mode)
    return ([seg(s) for s in plan.segments], pol(plan.embed_policy),
            pol(plan.head_policy))


@pytest.mark.parametrize("build", [
    lambda P, q: P.uniform(40),
    lambda P, q: P.mpai(40),
    lambda P, q: q.serve_plan(P.mpai(40)),
    lambda P, q: q.serve_plan(P.mpai(2), use_pallas=True),
    lambda P, q: q.serve_plan(P.mpai(12, split=5)),
    lambda P, q: q.serve_plan(P.mpai(8)).align_to_period(4, 8),
    lambda P, q: P.uniform(6, q.serve_plan(P.mpai(6)).segments[0].policy),
], ids=["uniform", "mpai", "serve", "serve-pallas", "split", "aligned",
        "uniform-int8"])
def test_partition_plans_equal(build):
    assert _plan_fields(build(TPlan, tqat)) == _plan_fields(build(JPlan, jqat))


def test_plan_validate_rejects_the_same_plans():
    for bad in (lambda P: P.mpai(8).validate(9),
                lambda P: P.uniform(8).validate(8, period=3)):
        with pytest.raises(ValueError):
            bad(JPlan)
        with pytest.raises(ValueError):
            bad(TPlan)
