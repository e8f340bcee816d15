"""The port's MoE MLP against ``repro.models.moe`` on shared weights.

``moe_apply`` (output and load-balancing loss) under the bf16 and int8
policies, on the flat dropless dispatch (``t * k <= 4096``) and on the
per-row capacity dispatch that drops slots, with and without a shared
expert; the init tree equals the reference's.

The reference runs in a subprocess with XLA's excess precision off, so both
sides round every bf16 op as written (see ``test_torch_model.py``).  The
router is f32 in both, and its softmax sums in another order, so a gate can
round to another bf16 value: outputs are held within one bf16 ulp of their
largest magnitude, with at least 95% of elements identical; the loss, an
f32 mean, within 1e-6.  ``torch.topk`` does not promise the lower index on
ties as ``jax.lax.top_k`` does; the inputs have none, and the test checks.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.base import MoEConfig
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.models import moe as TMoE

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("bf16", "int8")
D = 32
# name -> (MoEConfig kwargs, B, S): the flat branch at a decode-like and a
# prefill-like size; the grouped branch (t * k > 4096) whose capacity of
# k * S * 1.0 / E slots per row drops the overflow
CASES = {
    "flat_decode": (dict(num_experts=4, top_k=2, d_ff_expert=48), 8, 1),
    "flat_prefill": (dict(num_experts=8, top_k=2, d_ff_expert=48), 3, 40),
    "flat_shared": (dict(num_experts=4, top_k=2, d_ff_expert=48,
                         shared_d_ff=40), 2, 9),
    "grouped_drops": (dict(num_experts=4, top_k=2, d_ff_expert=24,
                           capacity_factor=1.0), 2, 1040),
    "grouped_shared": (dict(num_experts=4, top_k=2, d_ff_expert=24,
                            capacity_factor=1.0, shared_d_ff=16), 2, 1040),
}


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


def _x(name):
    _, b, s = CASES[name]
    return np.random.default_rng(31).normal(size=(b, s, D)).astype(np.float32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_moe.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs.base import MoEConfig as JMoE
    from repro.core.precision import PrecisionPolicy
    from repro.models import moe as M

    res = {}
    for i, (name, (kw, _, _)) in enumerate(CASES.items()):
        moe = JMoE(**kw)
        params = M.moe_init(jax.random.PRNGKey(i), D, moe, True)
        _flatten(params, f"{name}/params", res)
        x = jnp.asarray(_x(name), jnp.bfloat16)
        for pname in POLICIES:
            pol = (PrecisionPolicy.int8() if pname == "int8"
                   else PrecisionPolicy.bf16())
            out, aux = jax.jit(functools.partial(
                M.moe_apply, moe=moe, act="silu", glu=True,
                policy=pol))(params, x=x)
            res[f"{name}/{pname}/out"] = np.asarray(out.astype(jnp.float32))
            res[f"{name}/{pname}/aux"] = np.asarray(aux)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_ref") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    arrays = dict(np.load(out))
    return arrays, {name: bridge.to_torch(_unflatten(arrays,
                                                     f"{name}/params"), "cpu")
                    for name in CASES}


def _routing(params, moe, x):
    """Router probabilities and the per-row slot of every assignment, as
    the grouped dispatch computes them."""
    b, s, _ = x.shape
    probs = torch.softmax(x.reshape(b * s, -1).float()
                          @ params["router"].float(), dim=-1)
    eids = torch.topk(probs, moe.top_k, dim=-1).indices.reshape(b, -1)
    onehot = torch.nn.functional.one_hot(eids, moe.num_experts)
    slot = torch.gather(torch.cumsum(onehot, 1) - onehot, -1,
                        eids[..., None])[..., 0]
    return probs, slot


@pytest.mark.parametrize("pname", POLICIES)
@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_equals_the_reference(ref, name, pname):
    arrays, params = ref
    kw, b, s = CASES[name]
    moe = MoEConfig(**kw)
    p = params[name]
    x = torch.from_numpy(_x(name)).bfloat16()
    probs, slot = _routing(p, moe, x)
    # no ties at the top-k boundary (jax breaks them to the lower index)
    top = torch.sort(probs, dim=-1, descending=True).values
    assert (top[:, moe.top_k - 1] > top[:, moe.top_k]).all()
    assert ((b * s * moe.top_k <= TMoE.FLAT_DISPATCH_MAX)
            == name.startswith("flat"))
    if name.startswith("grouped"):      # the capacity drops slots
        cap = int(moe.top_k * s * moe.capacity_factor / moe.num_experts)
        assert (slot >= cap).any()
    out, aux = TMoE.moe_apply(p, moe, x, "silu", True,
                              TPolicy.int8() if pname == "int8"
                              else TPolicy.bf16())
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, D)
    assert aux.dtype == torch.float32 and aux.shape == ()
    want = arrays[f"{name}/{pname}/out"]
    got = _f32(out)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)
    assert (got == want).mean() >= 0.95, (got == want).mean()
    np.testing.assert_allclose(aux.numpy(), arrays[f"{name}/{pname}/aux"],
                               rtol=1e-6)


def test_port_init_builds_the_reference_tree():
    import jax
    from repro.configs.base import MoEConfig as JMoE
    from repro.models import moe as M
    kw = CASES["flat_shared"][0]
    want = jax.eval_shape(lambda k: M.moe_init(k, D, JMoE(**kw), True),
                          jax.random.PRNGKey(0))
    got = TMoE.moe_init(3, D, MoEConfig(**kw), True, torch.Generator(),
                        "cpu")
    flat_w, flat_g = {}, {}
    _flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want), "",
             flat_w)
    _flatten(got, "", flat_g)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:                    # the port stacks 3 super-blocks
        assert tuple(flat_g[k].shape) == (3,) + flat_w[k].shape, k


def test_fake_quant_experts_are_refused():
    """Fake-quant (QAT) experts are ported now: they compute the bf16
    experts on fake-quantized weights and dispatch buffer, and pass the
    gradient straight through (held against the reference in
    ``test_torch_qat.py``)."""
    from repro_torch.core.quantization import fake_quant
    moe = MoEConfig(num_experts=2, top_k=1, d_ff_expert=8)
    p = TMoE.moe_init(1, 8, moe, True, torch.Generator().manual_seed(0),
                      "cpu")
    p = {k: v[0] for k, v in p.items()}
    buf = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(1)
                      ).bfloat16().requires_grad_(True)
    out = TMoE._expert_ffn(p, buf, "silu", True, TPolicy.int8_qat())
    pq = {k: fake_quant(v, channel_axis=-1) for k, v in p.items()}
    want = TMoE._expert_ffn(pq, fake_quant(buf.detach()), "silu", True,
                            TPolicy.bf16())
    assert torch.equal(out, want)
    out.float().sum().backward()
    assert buf.grad is not None and torch.isfinite(buf.grad.float()).all()


if __name__ == "__main__":
    _reference(sys.argv[1])
