"""The port's recurrent stacks with every floating parameter in bf16, as
the dry run feeds prefill and decode (``param_structs(cfg, tp,
bfloat16)``), against ``repro.models.transformer`` on the same weights.

Where an f32 activation meets a bf16 parameter in a product (RWKV-6's
token-shift and decay LoRAs, Mamba's decode conv, the wkv bonus ``u``, the
scan's ``A`` and ``D``), JAX promotes the pair to f32; the port does the
same (``layers.promoted``) instead of refusing mixed operands.

The reference's seeded init of ``rwkv6-smoke`` and ``jamba-smoke`` is cast
to bf16 leaf by leaf, bridged, and both packages prefill one batch and take
three decode steps, each step fed the reference's greedy tokens.  The
reference runs in a subprocess with XLA's excess precision off (see
``test_torch_model.py``).  Prefill logits are held within one bf16 ulp of
their largest magnitude, and 95% of them identical, as the model tests
hold them.  A bf16 dot sums its f32 products in another order in each
library, so one output of a few hundred can round to the neighbouring
bf16 value (on ``jamba-smoke``'s third decode step, one element of a dense
MLP's ``w_out`` product); the stack carries that ulp through five more
layers.  So decode logits are held to 3e-2 of their norm, the bf16
tolerance of ``test_torch_recurrent_train.py``.  Greedy tokens are equal
wherever the reference's top two logits are more than one bf16 ulp of the
largest logit apart (ROADMAP, "Greedy near-ties").
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import jamba_v0_1_52b as tj
from repro_torch.configs import rwkv6_3b as tr
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"rwkv6": tr.SMOKE, "jamba": tj.SMOKE}
B, S, STEPS = 2, 8, 3


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


def _tokens(cfg):
    return np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_bf16_params.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import jamba_v0_1_52b as jj
    from repro.configs import rwkv6_3b as jr
    from repro.models import transformer as T

    res = {}
    for name, cfg in (("rwkv6", jr.SMOKE), ("jamba", jj.SMOKE)):
        params = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16)
            if jnp.issubdtype(a.dtype, jnp.floating) else a,
            T.model_init(jax.random.PRNGKey(0), cfg))
        # bf16 values are exact in f32; the port casts them back
        _flatten(jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32))
            if a.dtype == jnp.bfloat16 else np.asarray(a), params),
            f"{name}/params", res)
        prefill = jax.jit(lambda p, t, c: T.prefill(p, cfg, t, c))
        decode = jax.jit(lambda p, t, c: T.decode_step(p, cfg, t, c))
        out = prefill(params, jnp.asarray(_tokens(cfg)),
                      T.init_cache(cfg, B, S + STEPS))
        res[f"{name}/prefill"] = np.asarray(out.logits.astype(jnp.float32))
        cache, tok = out.cache, jnp.argmax(out.logits[:, -1], -1)[:, None]
        steps, fed = [], []
        for _ in range(STEPS):
            fed.append(np.asarray(tok, np.int32))
            o = decode(params, tok.astype(jnp.int32), cache)
            cache = o.cache
            steps.append(np.asarray(o.logits.astype(jnp.float32)))
            tok = jnp.argmax(o.logits[:, -1], -1)[:, None]
        res[f"{name}/decode"] = np.stack(steps)
        res[f"{name}/fed"] = np.stack(fed)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("bf16_params_ref") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def _params(arrays, name):
    """The bridged tree with every floating leaf bf16, as the reference's."""
    return tree_map(lambda t: t.bfloat16() if t.is_floating_point() else t,
                    bridge.to_torch(_unflatten(arrays, f"{name}/params"),
                                    "cpu"))


def _assert_within_one_bf16_ulp(got, want, identical=0.95):
    got = got.float().numpy()
    ulp = _ulp(want)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)
    assert (got == want).mean() >= identical, (got == want).mean()
    return ulp


def _ulp(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _assert_greedy_equal_off_near_ties(got, want, ulp):
    """argmax of the last position equal where the reference's top two
    logits are more than ``ulp`` apart."""
    last = want[:, -1]
    top2 = np.sort(last, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > ulp
    g = got[:, -1].float().argmax(-1).numpy()
    assert (g[clear] == last.argmax(-1)[clear]).all()


def _run(arrays, name):
    cfg = CONFIGS[name]
    params = _params(arrays, name)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params)
               if t.is_floating_point())
    cache = TT.init_cache(cfg, B, S + STEPS, device="cpu")
    with torch.no_grad():
        out = TT.prefill(params, cfg, torch.from_numpy(_tokens(cfg)), cache)
        steps = []
        cache = out.cache
        for fed in arrays[f"{name}/fed"]:
            o = TT.decode_step(params, cfg, torch.from_numpy(fed), cache)
            cache = o.cache
            steps.append(o.logits)
    return out.logits, steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_with_bf16_parameters_equals_the_reference(ref, name):
    logits, _ = _run(ref, name)
    want = ref[f"{name}/prefill"]
    assert logits.dtype == torch.bfloat16
    assert tuple(logits.shape) == want.shape
    ulp = _assert_within_one_bf16_ulp(logits, want)
    _assert_greedy_equal_off_near_ties(logits, want, ulp)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_with_bf16_parameters_equals_the_reference(ref, name):
    _, steps = _run(ref, name)
    want = ref[f"{name}/decode"]
    assert len(steps) == STEPS
    for got, w in zip(steps, want):
        assert tuple(got.shape) == w.shape
        g = got.float().numpy()
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w), \
            np.linalg.norm(g - w) / np.linalg.norm(w)
        _assert_greedy_equal_off_near_ties(got, w, _ulp(w))


if __name__ == "__main__":
    _reference(sys.argv[1])
