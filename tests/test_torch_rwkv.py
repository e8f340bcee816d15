"""The port's RWKV-6 mixer against ``repro.models.rwkv`` on shared weights.

* configs and the init tree (keys, shapes, dtypes) equal the reference's;
* ``wkv_plain`` (the CPU side of the wkv kernel) against the reference's
  oracle ``ref.wkv_ref``, its Pallas kernel run through ``ops.wkv`` in
  interpret mode, and the time mix's ``_wkv_chunk_scan`` (y and the final
  state);
* each mixer function under the bf16 and int8 policies, fed the same
  bridged weights and inputs: ``time_mix_apply`` (out, final state, last
  token), ``time_mix_decode``, ``channel_mix_apply`` / ``decode`` and
  ``_group_norm``.

The mixer outputs of the reference come from a subprocess with XLA's
excess precision off, so both sides round every bf16 op as written (see
``test_torch_model.py``).  Tolerances: f32 recurrences sum in another
order (sequential vs associative scan, einsum vs XLA dot), held to 1e-4 as
the reference's own kernel tests hold them; bf16 outputs to one bf16 ulp
of their largest magnitude, because an f32 difference in the last bits
can move a bf16 rounding by one ulp.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import rwkv6_3b as tr
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.kernels import wkv as twkv
from repro_torch.models import rwkv as TR
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
POLICIES = ("bf16", "int8")
B, S = 2, 7
RNG = np.random.default_rng(11)


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


def _assert_within_one_bf16_ulp(got, want):
    got, want = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_rwkv.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import functools

    import jax
    import jax.numpy as jnp
    from repro.configs import rwkv6_3b as jr
    from repro.core.precision import PrecisionPolicy
    from repro.models import rwkv as R
    from repro.models import transformer as T

    cfg = jr.SMOKE
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    layer0 = jax.tree.map(lambda a: a[0], params["layers"]["sub_0"])
    res = {}
    _flatten(layer0, "params", res)
    hp, n, dp = R.rwkv_dims(cfg, 1)
    rng = np.random.default_rng(5)
    bf = lambda *s: jnp.asarray(rng.normal(size=s), jnp.bfloat16)
    x, prev = bf(B, S, cfg.d_model), bf(B, cfg.d_model)
    state = jnp.asarray(rng.normal(size=(B, hp, n, n)) * 0.1, jnp.float32)
    y = jnp.asarray(rng.normal(size=(B, S, dp)) * 3 + 1, jnp.float32)
    zeros = jnp.zeros((B, cfg.d_model), jnp.float32)   # a fresh cache's
    for name, a in (("x", x), ("prev", prev), ("state", state), ("y", y)):
        res[f"in/{name}"] = np.asarray(a.astype(jnp.float32))
    mix, mlp = layer0["mixer"], layer0["mlp"]
    for pname in POLICIES:
        pol = (PrecisionPolicy.int8() if pname == "int8"
               else PrecisionPolicy.bf16())
        tm = jax.jit(functools.partial(R.time_mix_apply, cfg=cfg, policy=pol))
        td = jax.jit(functools.partial(R.time_mix_decode, cfg=cfg,
                                       policy=pol))
        cm = jax.jit(functools.partial(R.channel_mix_apply, policy=pol))
        cd = jax.jit(functools.partial(R.channel_mix_decode, policy=pol))
        outs = {}
        for pv_name, pv in (("zeros", zeros), ("prev", prev)):
            o, s_fin, last = tm(mix, x=x, x_prev=pv)
            outs[f"tmix_{pv_name}/out"] = o
            outs[f"tmix_{pv_name}/s_fin"] = s_fin
            outs[f"tmix_{pv_name}/last"] = last
            o, last = cm(mlp, x=x, x_prev=pv)
            outs[f"cmix_{pv_name}/out"] = o
            outs[f"cmix_{pv_name}/last"] = last
        o, s_new, xo = td(mix, x=x[:, 0], cache_s=state, x_prev=prev)
        outs["tdec/out"], outs["tdec/s_new"], outs["tdec/x"] = o, s_new, xo
        o, xo = cd(mlp, x=x[:, 0], x_prev=prev)
        outs["cdec/out"], outs["cdec/x"] = o, xo
        for k, v in outs.items():
            res[f"{pname}/{k}"] = np.asarray(v.astype(jnp.float32))
            res[f"{pname}/{k}/dtype"] = np.array(str(v.dtype))
    res["group_norm"] = np.asarray(jax.jit(
        lambda p, y: R._group_norm(p, y, n))(mix, y))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("rwkv_ref") / "ref.npz"
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
    params = bridge.to_torch(_unflatten(arrays, "params"), "cpu")
    return arrays, params


def _policy(pname):
    return TPolicy.int8() if pname == "int8" else TPolicy.bf16()


def _inputs(arrays):
    t = lambda k: torch.from_numpy(arrays[f"in/{k}"])
    return (t("x").bfloat16(), t("prev").bfloat16(), t("state"), t("y"),
            torch.zeros((B, tr.SMOKE.d_model), dtype=torch.float32))


def _check(arrays, key, got):
    want = arrays[key]
    assert str(got.dtype).replace("torch.", "") == str(arrays[key + "/dtype"])
    if got.dtype == torch.float32:
        np.testing.assert_allclose(_f32(got), want, rtol=1e-4, atol=1e-4)
    else:
        _assert_within_one_bf16_ulp(got, want)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["FULL", "SMOKE"])
def test_configs_equal_the_reference(name):
    from repro.configs import rwkv6_3b as jr
    got, want = getattr(tr, name), getattr(jr, name)
    assert {f: getattr(got, f) for f in got.__dataclass_fields__
            if f != "rwkv"} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__
         if f != "rwkv"}
    assert got.rwkv.__dict__ == want.rwkv.__dict__
    assert got.param_count() == want.param_count()


@pytest.mark.parametrize("tp", [1, 3])
def test_port_init_builds_the_reference_tree(tp):
    import jax
    from repro.configs import rwkv6_3b as jr
    from repro.models import transformer as T
    want = jax.eval_shape(lambda k: T.model_init(k, jr.SMOKE, tp),
                          jax.random.PRNGKey(0))
    got = TT.model_init(tr.SMOKE, torch.Generator().manual_seed(0),
                        device="cpu", tp=tp)
    flat_w, flat_g = {}, {}
    _flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want), "",
             flat_w)
    _flatten(got, "", flat_g)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        assert tuple(flat_g[k].shape) == flat_w[k].shape, k
        assert flat_g[k].dtype == np.float32, k
    mix = got["layers"]["sub_0"]["mixer"]
    d = tr.SMOKE.d_model
    # padded heads emit exact zeros: zero out-columns, zero w_o rows
    assert not mix["w_r"][:, :, d:].any() and not mix["w_o"][:, d:].any()


def test_init_cache_gives_each_super_block_its_own_state():
    cfg = tr.SMOKE
    cache = TT.init_cache(cfg, 3, 16, device="cpu")
    states = cache["sub_0"]
    assert len(states) == cfg.num_layers
    hp, n, _ = TR.rwkv_dims(cfg, 1)
    assert states[0].s.shape == (3, hp, n, n)
    assert states[0].x_tmix.dtype == torch.float32
    assert states[0].s.data_ptr() != states[1].s.data_ptr()


# ---------------------------------------------------------------------------
# the wkv recurrence (CPU side of the kernel)
# ---------------------------------------------------------------------------
def _wkv_inputs(b, s, h, n):
    mk = lambda: RNG.normal(size=(b, s, h, n)).astype(np.float32)
    w = np.exp(-np.exp(RNG.normal(size=(b, s, h, n)) - 1)).astype(np.float32)
    u = RNG.normal(size=(h, n)).astype(np.float32)
    return mk(), mk(), mk(), w, u


@pytest.mark.parametrize("b,s,h,n,q", [
    (2, 64, 2, 8, 16),
    (1, 21, 3, 16, 7),            # ragged seq
    (2, 32, 1, 64, 32),           # full head size
])
def test_wkv_plain_matches_oracle_and_pallas(b, s, h, n, q):
    import jax.numpy as jnp
    from repro.kernels import ops
    args = _wkv_inputs(b, s, h, n)
    jargs = [jnp.asarray(a) for a in args]
    before = twkv.wkv.launches
    y, s_fin = twkv.wkv(*(torch.from_numpy(a) for a in args))   # CPU: plain
    assert twkv.wkv.launches == before
    assert y.shape == (b, s, h, n) and s_fin.shape == (b, h, n, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(ops.wkv_ref(*jargs)),
                               atol=1e-4)
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(ops.wkv(*jargs, q=q)), atol=1e-4)


@pytest.mark.parametrize("s,chunk", [(24, 6), (19, 16)])
def test_wkv_plain_matches_chunk_scan_output_and_state(s, chunk):
    import jax.numpy as jnp
    from repro.models.rwkv import _wkv_chunk_scan
    b, h, n = 2, 2, 8
    r, k, v, w, u = _wkv_inputs(b, s, h, n)
    j = jnp.asarray
    y_x, s_x = _wkv_chunk_scan(jnp.zeros((b, h, n, n), jnp.float32), j(w),
                               j(k), j(v), j(r), j(u), chunk=chunk)
    y, s_fin = twkv.wkv_plain(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_x), atol=1e-4)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(s_x), atol=1e-4)


def test_wkv_wrapper_rejects_mismatched_shapes():
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(1, 4, 2, 8))
    with pytest.raises(ValueError):
        twkv.wkv(r, k[:, :3], v, w, u)
    with pytest.raises(ValueError):
        twkv.wkv(r, k, v, w, u[:1])


# ---------------------------------------------------------------------------
# the mixers on bridged weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prev_name", ["zeros", "prev"])
@pytest.mark.parametrize("pname", POLICIES)
def test_time_mix_apply_equals_the_reference(ref, pname, prev_name):
    arrays, params = ref
    x, prev, _, _, zeros = _inputs(arrays)
    pv = zeros if prev_name == "zeros" else prev
    out, s_fin, last = TR.time_mix_apply(params["mixer"], tr.SMOKE, x, pv,
                                         policy=_policy(pname))
    key = f"{pname}/tmix_{prev_name}"
    _check(arrays, f"{key}/out", out)
    _check(arrays, f"{key}/s_fin", s_fin)
    _check(arrays, f"{key}/last", last)


@pytest.mark.parametrize("pname", POLICIES)
def test_time_mix_decode_equals_the_reference(ref, pname):
    arrays, params = ref
    x, prev, state, _, _ = _inputs(arrays)
    out, s_new, xo = TR.time_mix_decode(params["mixer"], tr.SMOKE, x[:, 0],
                                        state, prev, policy=_policy(pname))
    _check(arrays, f"{pname}/tdec/out", out)
    _check(arrays, f"{pname}/tdec/s_new", s_new)
    _check(arrays, f"{pname}/tdec/x", xo)


@pytest.mark.parametrize("prev_name", ["zeros", "prev"])
@pytest.mark.parametrize("pname", POLICIES)
def test_channel_mix_apply_and_decode_equal_the_reference(ref, pname,
                                                         prev_name):
    arrays, params = ref
    x, prev, _, _, zeros = _inputs(arrays)
    pv = zeros if prev_name == "zeros" else prev
    out, last = TR.channel_mix_apply(params["mlp"], x, pv, _policy(pname))
    _check(arrays, f"{pname}/cmix_{prev_name}/out", out)
    _check(arrays, f"{pname}/cmix_{prev_name}/last", last)
    out, xo = TR.channel_mix_decode(params["mlp"], x[:, 0], prev,
                                    _policy(pname))
    _check(arrays, f"{pname}/cdec/out", out)
    _check(arrays, f"{pname}/cdec/x", xo)


def test_group_norm_equals_the_reference(ref):
    arrays, params = ref
    _, _, _, y, _ = _inputs(arrays)
    got = TR._group_norm(params["mixer"], y, tr.SMOKE.rwkv.head_size)
    np.testing.assert_allclose(got.numpy(), arrays["group_norm"], rtol=1e-5,
                               atol=1e-5)


if __name__ == "__main__":
    _reference(sys.argv[1])
