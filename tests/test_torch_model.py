"""The port's dense model against ``repro.models.transformer`` on shared
weights, for ``tiny`` and ``qwen3-smoke`` under the bf16 and "mpai" plans:
bucket prefill, paged decode steps and chunked paged prefill.

The reference is run in a subprocess with XLA's excess precision off
(``--xla_allow_excess_precision=false``): XLA then rounds every bf16 op as
written, like PyTorch does.  Embedding, norms, projections, the int8
products and the MLP then agree bit for bit; the attention softmax sums in
f32 in another order (einsum vs XLA dot), which can move a bf16 result by
one ulp, and in an int8 segment such a move can flip one activation code.
So logits and KV pools are held within one bf16 ulp of their largest
magnitude, and at least 95% of them must be identical.  With the flag at its default XLA keeps f32 inside
fusions and the two differ by a few bf16 ulps; one in-process test pins
that tolerance too.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import qwen3_14b as tq3
from repro_torch.configs.tiny import TINY
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.runtime import paging as tpg

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"tiny": TINY, "smoke": tq3.SMOKE}
PLANS = ("bf16", "mpai")
B, S, PAGE, NB, MB, STEPS = 2, 8, 4, 8, 4, 3


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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
    a = a.float() if isinstance(a, torch.Tensor) else a.astype(np.float32)
    return np.asarray(a)


def _assert_within_one_bf16_ulp(got, want, identical=0.95):
    """|got - want| <= one bf16 ulp of max|want|, and at least
    ``identical`` of the elements equal."""
    got, want = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)
    assert (got == want).mean() >= identical, (got == want).mean()


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_model.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import qwen3_14b as jq3
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T
    from repro.runtime import paging
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    res = {}
    for cname, cfg in (("tiny", tiny_dense()), ("smoke", jq3.SMOKE)):
        params = T.model_init(jax.random.PRNGKey(0), cfg)
        _flatten(params, f"{cname}/params", res)
        for pname in PLANS:
            plan = (qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
                    if pname == "mpai" else None)
            key = f"{cname}/{pname}"
            toks = jnp.asarray(_tokens(cfg, 0))
            prefill = jax.jit(lambda p, t, c: T.prefill(p, cfg, t, c, plan))
            decode = jax.jit(lambda p, t, c: T.decode_step(p, cfg, t, c, plan))
            chunk = jax.jit(lambda p, t, c, s: T.prefill_paged_chunk(
                p, cfg, t, c, 0, s, plan))
            caches = _paged(T, cfg)
            out = prefill(params, toks, T.init_cache(cfg, B, S))
            res[f"{key}/prefill"] = np.asarray(out.logits.astype(jnp.float32))
            caches = {k: jax.vmap(paging.write_prefill_batch,
                                  in_axes=(0, 0, 0, None))(
                          st, out.cache[k].k, out.cache[k].v,
                          jnp.ones(B, bool)) for k, st in caches.items()}
            tok = jnp.argmax(out.logits[:, -1], -1)[:, None]
            steps, fed = [], []
            for _ in range(STEPS):
                fed.append(np.asarray(tok, np.int32))
                o = decode(params, tok.astype(jnp.int32), caches)
                caches = o.cache
                steps.append(np.asarray(o.logits.astype(jnp.float32)))
                tok = jnp.argmax(o.logits[:, -1], -1)[:, None]
            res[f"{key}/decode"] = np.stack(steps)
            res[f"{key}/fed"] = np.stack(fed)
            res[f"{key}/k_pool"] = _f32(caches["sub_0"].k_pool[:, :-1])
            res[f"{key}/v_pool"] = _f32(caches["sub_0"].v_pool[:, :-1])
            caches = _paged(T, cfg)
            long = jnp.asarray(_tokens(cfg, 1).reshape(1, -1))
            chunks = []
            for start in (0, S):
                o = chunk(params, long[:, start:start + S], caches, start)
                caches = o.cache
                chunks.append(np.asarray(o.logits.astype(jnp.float32)))
            res[f"{key}/chunks"] = np.stack(chunks)
            res[f"{key}/chunk_k_pool"] = _f32(caches["sub_0"].k_pool[:, :-1])
    np.savez(out_path, **res)


def _table():
    return np.arange(B * MB, dtype=np.int32).reshape(B, MB)[:, ::-1].copy()


def _paged(T, cfg):
    """Paged caches with each sequence owning MB blocks (JAX reference)."""
    import jax
    import jax.numpy as jnp
    caches = T.init_paged_decode_cache(cfg, B, NB, PAGE, max_blocks=MB)
    tbl = jnp.asarray(_table())
    return jax.tree_util.tree_map(
        lambda st: st._replace(block_table=jnp.broadcast_to(
            tbl, st.block_table.shape)), caches,
        is_leaf=lambda s: hasattr(s, "block_table"))


def _paged_port(cfg):
    caches = TT.init_paged_decode_cache(cfg, B, NB, PAGE, max_blocks=MB,
                                        device="cpu")
    for st in caches.values():
        st.block_table.copy_(torch.as_tensor(_table()).expand_as(
            st.block_table))
    return caches


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("model_ref") / "ref.npz"
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


def _plan(cfg, pname):
    return (tqat.serve_plan(TPlan.mpai(cfg.num_layers)) if pname == "mpai"
            else None)


@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_prefill_and_decode_within_one_bf16_ulp(ref, cname, pname):
    cfg, plan = CONFIGS[cname], _plan(CONFIGS[cname], pname)
    params = bridge.to_torch(_unflatten(ref, f"{cname}/params"), "cpu")
    key = f"{cname}/{pname}"
    caches = _paged_port(cfg)
    out = TT.prefill(params, cfg, torch.as_tensor(_tokens(cfg, 0)),
                     TT.init_cache(cfg, B, S, device="cpu"), plan)
    _assert_within_one_bf16_ulp(out.logits, ref[f"{key}/prefill"])
    for k, st in caches.items():
        for layer in range(st.k_pool.shape[0]):
            tpg.write_prefill_batch(TT.tree_map(lambda a: a[layer], st),
                                    out.cache[k].k[layer],
                                    out.cache[k].v[layer],
                                    torch.ones(B, dtype=torch.bool))
    for step in range(STEPS):       # fed the reference's greedy tokens
        o = TT.decode_step(params, cfg,
                           torch.as_tensor(ref[f"{key}/fed"][step]), caches,
                           plan)
        _assert_within_one_bf16_ulp(o.logits, ref[f"{key}/decode"][step])
    st = caches["sub_0"]
    _assert_within_one_bf16_ulp(st.k_pool[:, :-1], ref[f"{key}/k_pool"])
    _assert_within_one_bf16_ulp(st.v_pool[:, :-1], ref[f"{key}/v_pool"])
    assert st.lengths.tolist() == [[S + STEPS] * B] * cfg.num_layers


@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_chunked_paged_prefill_within_one_bf16_ulp(ref, cname, pname):
    cfg, plan = CONFIGS[cname], _plan(CONFIGS[cname], pname)
    params = bridge.to_torch(_unflatten(ref, f"{cname}/params"), "cpu")
    key = f"{cname}/{pname}"
    caches = _paged_port(cfg)
    long = torch.as_tensor(_tokens(cfg, 1).reshape(1, -1))
    for i, start in enumerate((0, S)):
        o = TT.prefill_paged_chunk(params, cfg, long[:, start:start + S],
                                   caches, 0, start, plan)
        _assert_within_one_bf16_ulp(o.logits, ref[f"{key}/chunks"][i])
    _assert_within_one_bf16_ulp(caches["sub_0"].k_pool[:, :-1],
                                ref[f"{key}/chunk_k_pool"])
    assert caches["sub_0"].lengths[:, 0].tolist() == [2 * S] * cfg.num_layers


@pytest.mark.parametrize("pname", PLANS)
def test_prefill_logits_within_tolerance_of_default_xla(pname):
    """The reference as XLA runs it by default (excess precision on, in
    this process): the port rounds each bf16 op where XLA's fusions keep
    f32, so logits differ by a few bf16 ulps (2**-8 relative each) of the
    logit scale, and greedy picks agree wherever the top two are apart."""
    import jax
    import jax.numpy as jnp
    from conftest import tiny_dense
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T
    cfg = tiny_dense()
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    plan = qat.serve_plan(PartitionPlan.mpai(2)) if pname == "mpai" else None
    toks = _tokens(cfg, 0)
    want = np.asarray(jax.jit(lambda p, t: T.forward(p, cfg, t, plan).logits)(
        params, jnp.asarray(toks)).astype(jnp.float32))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params), "cpu")
    got = TT.forward(tparams, TINY, torch.as_tensor(toks), _plan(TINY, pname)
                     ).logits.float().numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -5 * scale)
    top2 = np.sort(want, axis=-1)[..., -2:]
    apart = (top2[..., 1] - top2[..., 0]) > 2 ** -4 * scale
    np.testing.assert_array_equal(got.argmax(-1)[apart],
                                  want.argmax(-1)[apart])


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_configs_equal_the_reference(cname):
    from conftest import tiny_dense
    from repro.configs import qwen3_14b as jq3
    want = {"tiny": tiny_dense(), "smoke": jq3.SMOKE}[cname]
    got = CONFIGS[cname]
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert tq3.FULL.__dict__ == jq3.FULL.__dict__


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_port_init_builds_the_reference_tree(cname):
    import jax
    from repro.models import transformer as T
    cfg = CONFIGS[cname]
    from conftest import tiny_dense
    from repro.configs import qwen3_14b as jq3
    jcfg = {"tiny": tiny_dense(), "smoke": jq3.SMOKE}[cname]
    want = jax.eval_shape(lambda k: T.model_init(k, jcfg),
                          jax.random.PRNGKey(0))
    got = TT.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_w, flat_g = {}, {}
    _flatten(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want), "", flat_w)
    _flatten(got, "", flat_g)
    assert sorted(flat_g) == sorted(flat_w)
    for k in flat_w:
        assert tuple(flat_g[k].shape) == flat_w[k].shape, k
        assert flat_g[k].dtype == np.float32, k
    again = TT.model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["sub_0"]["mixer"]["wq"],
                       got["layers"]["sub_0"]["mixer"]["wq"])


@pytest.mark.parametrize("h,kv,tp", [(40, 8, 1), (40, 8, 16), (4, 2, 1),
                                     (32, 8, 3), (14, 2, 4)])
def test_head_layout_and_slot_maps_equal(h, kv, tp):
    from repro.models import attention as JA
    lay = TA.head_layout(h, kv, tp)
    assert tuple(lay) == tuple(JA.head_layout(h, kv, tp))
    np.testing.assert_array_equal(TA.q_slot_map(lay).numpy(),
                                  np.asarray(JA.q_slot_map(lay)))
    np.testing.assert_array_equal(TA.kv_slot_map(lay).numpy(),
                                  np.asarray(JA.kv_slot_map(lay)))


def test_non_dense_stacks_are_refused():
    with pytest.raises(NotImplementedError):
        TT.model_init(TINY.with_(mixer="mamba"), torch.Generator(),
                      device="cpu")


if __name__ == "__main__":
    _reference(sys.argv[1])
