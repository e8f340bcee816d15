"""The port's Mamba mixer and the Jamba configs against the reference.

* configs (``jamba-v0.1-52b`` FULL and SMOKE) and the init tree of
  ``jamba-smoke`` (keys, shapes, dtypes) equal the reference's;
* ``selective_scan_plain`` (the CPU side of the selective-scan kernel)
  against the reference's oracle ``ref.selective_scan_ref``, its Pallas
  kernel run through ``ops.selective_scan`` in interpret mode, and the
  mixer's own chunked associative scan (``mamba._chunk_scan``), y and the
  final state, ragged S included;
* ``mamba_apply`` (output and the ``MambaCache`` it returns) and
  ``mamba_decode_step`` under the bf16 and int8 policies, fed the same
  bridged weights and inputs;
* the whole ``jamba-smoke`` forward under an f32 plan: logits, and the
  MoE load-balancing losses summed into ``LMOutput.aux_loss``.  In bf16 a
  one-ulp move upstream can flip a token's top-2 experts where two router
  probabilities lie within ~1e-4 (one token of 22 here, at a margin of
  5e-5), and that token's output then differs wholesale; bf16 and "mpai"
  are held at the level of greedy streams (``test_torch_windowed.py``).

The mixer outputs of the reference come from a subprocess with XLA's
excess precision off, so both sides round every bf16 op as written (see
``test_torch_model.py``).  Tolerances: f32 recurrences sum in another order
(sequential vs associative scan) and ``softplus`` differs in the last f32
bit (ROADMAP, parity hazards), held to 1e-4 as the reference's own kernel
tests hold them.  The bf16 outputs are held within one bf16 ulp of their
largest magnitude: an f32 difference in the last bits can move a bf16
rounding by one ulp, and under int8 it can move one activation code.
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
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import selective_scan as tss
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("bf16", "int8")
B, S = 2, 11
RNG = np.random.default_rng(17)


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
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      np.asarray(a, np.float32))


def _tokens():
    return np.random.default_rng(9).integers(
        0, tj.SMOKE.vocab_size, (B, S)).astype(np.int32)


def _assert_within_one_bf16_ulp(got, want):
    got, want = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_mamba.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs import jamba_v0_1_52b as jj
    from repro.core.precision import PrecisionPolicy
    from repro.models import mamba as M
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T

    cfg = jj.SMOKE
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    mix = jax.tree.map(lambda a: a[0], params["layers"]["sub_1"]["mixer"])
    res = {}
    _flatten(mix, "params", res)
    _flatten(params, "model", res)
    toks = jnp.asarray(_tokens())
    plan = PartitionPlan.uniform(cfg.num_layers, PrecisionPolicy.fp32())
    out = jax.jit(lambda p, t: T.forward(p, cfg, t, plan))(params, toks)
    res["forward/logits"] = np.asarray(out.logits)
    res["forward/aux"] = np.asarray(out.aux_loss)
    di, n = 2 * cfg.d_model, cfg.mamba.d_state
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(B, S, cfg.d_model)), jnp.bfloat16)
    h = jnp.asarray(rng.normal(size=(B, di, n)) * 0.5, jnp.float32)
    conv = jnp.asarray(rng.normal(size=(B, cfg.mamba.d_conv - 1, di)),
                       jnp.float32)
    for name, a in (("x", x), ("h", h), ("conv", conv)):
        res[f"in/{name}"] = np.asarray(a.astype(jnp.float32))
    for pname in POLICIES:
        pol = (PrecisionPolicy.int8() if pname == "int8"
               else PrecisionPolicy.bf16())
        app = jax.jit(functools.partial(M.mamba_apply, cfg=cfg, policy=pol,
                                        return_state=True))
        dec = jax.jit(functools.partial(M.mamba_decode_step, cfg=cfg,
                                        policy=pol))
        out, st = app(mix, x=x)
        outs = {"apply/out": out, "apply/h": st.h, "apply/conv": st.conv}
        out, st = dec(mix, x=x[:, :1], cache=M.MambaCache(h, conv))
        outs.update({"decode/out": out, "decode/h": st.h,
                     "decode/conv": st.conv})
        for k, v in outs.items():
            res[f"{pname}/{k}"] = np.asarray(v.astype(jnp.float32))
            res[f"{pname}/{k}/dtype"] = np.array(str(v.dtype))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mamba_ref") / "ref.npz"
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
    return (arrays, bridge.to_torch(_unflatten(arrays, "params"), "cpu"),
            bridge.to_torch(_unflatten(arrays, "model"), "cpu"))


def _policy(pname):
    return TPolicy.int8() if pname == "int8" else TPolicy.bf16()


def _check(arrays, key, got):
    want = arrays[key]
    assert str(got.dtype).replace("torch.", "") == str(arrays[key + "/dtype"])
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.float32:
        np.testing.assert_allclose(_f32(got), want, rtol=1e-4, atol=1e-4)
    else:
        _assert_within_one_bf16_ulp(got, want)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["FULL", "SMOKE"])
def test_configs_equal_the_reference(name):
    from repro.configs import jamba_v0_1_52b as jj
    got, want = getattr(tj, name), getattr(jj, name)
    nested = ("moe", "mamba")
    assert {f: getattr(got, f) for f in got.__dataclass_fields__
            if f not in nested} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__
         if f not in nested}
    for f in nested:
        assert getattr(got, f).__dict__ == getattr(want, f).__dict__
    assert got.param_count() == want.param_count()
    # the one-super-block depth the chip run serves
    assert got.with_(num_layers=8).param_count() == \
        want.with_(num_layers=8).param_count()


def test_port_init_builds_the_reference_tree():
    import jax
    from repro.configs import jamba_v0_1_52b as jj
    from repro.models import transformer as T
    want = jax.eval_shape(lambda k: T.model_init(k, jj.SMOKE),
                          jax.random.PRNGKey(0))
    got = TT.model_init(tj.SMOKE, torch.Generator().manual_seed(0),
                        device="cpu")
    flat_w, flat_g = {}, {}
    _flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want), "",
             flat_w)
    _flatten(got, "", flat_g)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        assert tuple(flat_g[k].shape) == flat_w[k].shape, k
        assert flat_g[k].dtype == np.float32, k


def test_init_cache_gives_each_mamba_super_block_its_own_state():
    cfg = tj.SMOKE.with_(num_layers=16)
    cache = TT.init_cache(cfg, 3, 12, device="cpu")
    assert isinstance(cache["sub_0"].k, torch.Tensor)
    states = cache["sub_1"]
    assert len(states) == 2 and isinstance(states[0], TM.MambaCache)
    di = cfg.mamba.expand * cfg.d_model
    assert states[0].h.shape == (3, di, cfg.mamba.d_state)
    assert states[0].conv.shape == (3, cfg.mamba.d_conv - 1, di)
    assert states[0].h.dtype == torch.float32
    assert states[0].h.data_ptr() != states[1].h.data_ptr()


# ---------------------------------------------------------------------------
# the selective scan (CPU side of the kernel)
# ---------------------------------------------------------------------------
def _scan_inputs(b, s, d, n):
    x = RNG.normal(size=(b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(RNG.normal(size=(b, s, d)) - 3)).astype(np.float32)
    bm = RNG.normal(size=(b, s, n)).astype(np.float32)
    cm = RNG.normal(size=(b, s, n)).astype(np.float32)
    a = -np.exp(RNG.normal(size=(d, n)) * 0.5).astype(np.float32)
    dd = RNG.normal(size=(d,)).astype(np.float32)
    return x, dt, bm, cm, a, dd


@pytest.mark.parametrize("b,s,d,n,bd,q", [
    (2, 64, 32, 4, 16, 16),
    (1, 21, 48, 8, 16, 8),        # ragged seq and channels
    (2, 9, 16, 16, 16, 9),
])
def test_selective_scan_plain_matches_oracle_and_pallas(b, s, d, n, bd, q):
    import jax.numpy as jnp
    from repro.kernels import ops
    args = _scan_inputs(b, s, d, n)
    jargs = [jnp.asarray(a) for a in args]
    before = tss.selective_scan.launches
    y, h = tss.selective_scan(*(torch.from_numpy(a) for a in args))
    assert tss.selective_scan.launches == before         # CPU: plain
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(ops.selective_scan_ref(*jargs)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(ops.selective_scan(*jargs, bd=bd, q=q)),
        rtol=1e-4, atol=1e-4)


def _chunked_reference(x, dt, bm, cm, a, dd, chunk):
    """The reference mixer's scan (``mamba_apply`` lines around
    ``_chunk_scan``), y with the skip term and the final state."""
    import jax
    import jax.numpy as jnp
    from repro.models.mamba import _chunk_scan
    b, s, d = x.shape
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    j = [jnp.pad(jnp.asarray(t), ((0, 0), (0, pad), (0, 0)))
         for t in (dt, bm, cm, x)]

    def outer(h, inp):
        dtq, bq, cq, xq = inp
        a_bar = jnp.exp(dtq[..., None] * a)
        bx = (dtq * xq)[..., None] * bq[:, :, None, :]
        hs, h_last = _chunk_scan(h, a_bar, bx)
        return h_last, jnp.einsum("bqdn,bqn->bqd", hs, cq)

    split = lambda t: t.reshape(b, nchunk, chunk, *t.shape[2:]).swapaxes(0, 1)
    h_fin, ys = jax.lax.scan(outer, jnp.zeros((b, d, a.shape[1])),
                             tuple(split(t) for t in j))
    y = ys.swapaxes(0, 1).reshape(b, nchunk * chunk, d)[:, :s] + x * dd
    return np.asarray(y), np.asarray(h_fin)


@pytest.mark.parametrize("s,chunk", [(24, 8), (19, 16)])
def test_selective_scan_plain_matches_chunk_scan_output_and_state(s, chunk):
    args = _scan_inputs(2, s, 24, 4)
    y_x, h_x = _chunked_reference(*args, chunk=chunk)
    y, h = tss.selective_scan_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(y.numpy(), y_x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_x, rtol=1e-4, atol=1e-4)


def test_selective_scan_wrapper_rejects_mismatched_shapes():
    x, dt, bm, cm, a, dd = (torch.from_numpy(t)
                            for t in _scan_inputs(1, 4, 8, 4))
    with pytest.raises(ValueError):
        tss.selective_scan(x, dt[:, :3], bm, cm, a, dd)
    with pytest.raises(ValueError):
        tss.selective_scan(x, dt, bm, cm, a[:4], dd)


# ---------------------------------------------------------------------------
# the mixer on bridged weights
# ---------------------------------------------------------------------------
def _inputs(arrays):
    t = lambda k: torch.from_numpy(arrays[f"in/{k}"])
    return t("x").bfloat16(), t("h"), t("conv")


@pytest.mark.parametrize("pname", POLICIES)
def test_mamba_apply_and_its_cache_equal_the_reference(ref, pname):
    arrays, params, _ = ref
    x, _, _ = _inputs(arrays)
    before = tss.selective_scan.launches
    out, st = TM.mamba_apply(params, tj.SMOKE, x, _policy(pname),
                             return_state=True)
    assert tss.selective_scan.launches == before
    _check(arrays, f"{pname}/apply/out", out)
    _check(arrays, f"{pname}/apply/h", st.h)
    _check(arrays, f"{pname}/apply/conv", st.conv)
    plain = TM.mamba_apply(params, tj.SMOKE, x, _policy(pname))
    assert torch.equal(plain, out)


@pytest.mark.parametrize("pname", POLICIES)
def test_mamba_decode_step_equals_the_reference(ref, pname):
    arrays, params, _ = ref
    x, h, conv = _inputs(arrays)
    out, st = TM.mamba_decode_step(params, tj.SMOKE, x[:, :1],
                                   TM.MambaCache(h, conv), _policy(pname))
    _check(arrays, f"{pname}/decode/out", out)
    _check(arrays, f"{pname}/decode/h", st.h)
    _check(arrays, f"{pname}/decode/conv", st.conv)


def test_decode_continues_the_prefill_state(ref):
    """One prefill of S tokens, then decode steps, gives the outputs of a
    prefill of the longer sequence (the conv tail and h carry over)."""
    _, params, _ = ref
    x, _, _ = _inputs(ref[0])
    x = x.float()                   # f32 policy: the algorithm, not rounding
    pol = TPolicy.fp32()
    full = TM.mamba_apply(params, tj.SMOKE, x, pol)
    _, st = TM.mamba_apply(params, tj.SMOKE, x[:, :S - 3], pol,
                           return_state=True)
    for t in range(S - 3, S):
        out, st = TM.mamba_decode_step(params, tj.SMOKE, x[:, t:t + 1], st,
                                       pol)
        torch.testing.assert_close(out[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-5)


def test_jamba_forward_logits_and_aux_loss_equal_the_reference(ref):
    from repro_torch.core.partition import PartitionPlan as TPlan
    arrays, _, model = ref
    plan = TPlan.uniform(tj.SMOKE.num_layers, TPolicy.fp32())
    out = TT.forward(model, tj.SMOKE, torch.as_tensor(_tokens()), plan)
    assert out.logits.dtype == torch.float32
    np.testing.assert_allclose(out.logits.numpy(), arrays["forward/logits"],
                               rtol=1e-4, atol=1e-4)
    # four MoE layers' f32 losses, each over the same routing
    assert out.aux_loss.dtype == torch.float32 and out.aux_loss.shape == ()
    np.testing.assert_allclose(out.aux_loss.numpy(), arrays["forward/aux"],
                               rtol=1e-5)
    assert out.aux_loss > 0


if __name__ == "__main__":
    _reference(sys.argv[1])
