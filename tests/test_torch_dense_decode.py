"""The port's dense-cache decode and int8 KV cache against the reference.

* The prefill-target cache of ``T.init_cache`` + ``T.prefill``: on an
  int8-KV config it holds int8 codes, f32 per-token-per-head scales and a
  ``pos`` counter, as ``repro.models.transformer._prefill_kv`` writes them
  (with and without a sliding window that bites, where the window is kept
  ring-aligned); on a bf16 config, bf16 k/v and ``pos``.
* ``T.decode_step`` against that dense cache (``decode_attention_apply``):
  logits of every step and the cache after the last, under the bf16 and
  "mpai" plans, with ring writes past the cache length under a sliding
  window.
* the row-wise quant, per token and head, equals the jitted reference's
  ``_cache_quant`` bit for bit, and
  ``rowwise_quant_plain`` (the CPU side of the row-wise quant kernel)
  equals the jitted ``ref.rowwise_quant_ref`` and the Pallas kernel run in
  interpret mode.

The model-level reference runs in a subprocess with XLA's excess precision
off, so both sides round every bf16 op as written (see
``test_torch_model.py``); logits and bf16 caches are then held within one
bf16 ulp of their largest magnitude, with at least 95% of the elements
identical.  An int8 code depends on its bf16 k/v element and on its row's
absmax, so a one-ulp move of either can move a code by one: codes are held
within one step, at least 95% identical, and scales within one bf16 ulp of
the row's absmax / 127.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.tiny import TINY
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.kernels import quant as tquant
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("bf16", "mpai")
# (kv cache dtype, sliding window): the window of 4 bites on an 8-token
# prefill, and the 6 decode steps write the ring past its length
CONFIGS = {"bf16": {}, "int8": {"kv_cache_dtype": "int8"},
           "bf16_window": {"sliding_window": 4},
           "int8_window": {"kv_cache_dtype": "int8", "sliding_window": 4}}
B, S, T_LEN, STEPS = 2, 8, 14, 6
FIELDS = ("k", "v", "pos", "k_scale", "v_scale")


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


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TINY.vocab_size, shape).astype(np.int32)


def _f32(a):
    a = a.float() if isinstance(a, torch.Tensor) else a.astype(np.float32)
    return np.asarray(a)


def _assert_within_one_bf16_ulp(got, want, identical=0.95):
    got, want = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp, (np.abs(got - want).max(), ulp)
    assert (got == want).mean() >= identical, (got == want).mean()


def _save_cache(res, key, kv):
    for f in FIELDS:
        a = getattr(kv, f)
        if a is not None:
            res[f"{key}/{f}"] = np.asarray(a.astype("float32")
                                           if a.dtype.name == "bfloat16"
                                           else a)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_dense_decode.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    res = {}
    params = T.model_init(jax.random.PRNGKey(0), tiny_dense())
    _flatten(params, "params", res)
    for cname, kw in CONFIGS.items():
        cfg = tiny_dense(**kw)
        for pname in PLANS:
            plan = (qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
                    if pname == "mpai" else None)
            key = f"{cname}/{pname}"
            prefill = jax.jit(lambda p, t, c: T.prefill(p, cfg, t, c, plan))
            decode = jax.jit(lambda p, t, c: T.decode_step(p, cfg, t, c,
                                                           plan))
            out = prefill(params, jnp.asarray(_tokens(0, (B, S))),
                          T.init_cache(cfg, B, T_LEN))
            res[f"{key}/prefill"] = np.asarray(out.logits.astype(jnp.float32))
            _save_cache(res, f"{key}/prefill_cache", out.cache["sub_0"])
            cache, steps = out.cache, []
            for tok in _tokens(1, (STEPS, B, 1)):
                o = decode(params, jnp.asarray(tok), cache)
                cache = o.cache
                steps.append(np.asarray(o.logits.astype(jnp.float32)))
            res[f"{key}/decode"] = np.stack(steps)
            _save_cache(res, f"{key}/decode_cache", cache["sub_0"])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dense_decode_ref") / "ref.npz"
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
    return arrays, bridge.to_torch(_unflatten(arrays, "params"), "cpu")


def _plan(pname):
    return (tqat.serve_plan(TPlan.mpai(TINY.num_layers)) if pname == "mpai"
            else None)


def _check_cache(arrays, key, cache):
    """The port's stacked cache of one attention sublayer against the
    reference's arrays under ``key``."""
    assert cache.pos.dtype == torch.int32
    np.testing.assert_array_equal(cache.pos.numpy(), arrays[f"{key}/pos"])
    if f"{key}/k_scale" not in arrays:
        assert not cache.quantized and cache.k_scale is None
        assert cache.k.dtype == torch.bfloat16
        _assert_within_one_bf16_ulp(cache.k, arrays[f"{key}/k"])
        _assert_within_one_bf16_ulp(cache.v, arrays[f"{key}/v"])
        return
    assert cache.quantized and cache.k.dtype == torch.int8
    for f in ("k", "v"):
        codes = getattr(cache, f).numpy().astype(int)
        want = arrays[f"{key}/{f}"]
        assert np.abs(codes - want).max() <= 1
        assert (codes == want).mean() >= 0.95, (codes == want).mean()
        scale = getattr(cache, f"{f}_scale")
        assert scale.dtype == torch.float32
        want_s = arrays[f"{key}/{f}_scale"]
        assert scale.shape == want_s.shape
        # one bf16 ulp of the row's absmax, over 127
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(want_s * 127, 1e-30))) - 7)
        assert (np.abs(scale.numpy() - want_s) <= ulp / 127 * 1.01).all()


# ---------------------------------------------------------------------------
# prefill-target cache (the repaired ``init_cache`` / ``_prefill_kv``)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_prefill_cache_equals_the_reference(ref, cname, pname):
    arrays, params = ref
    cfg = TINY.with_(**CONFIGS[cname])
    cache = TT.init_cache(cfg, B, T_LEN, device="cpu")
    out = TT.prefill(params, cfg, torch.as_tensor(_tokens(0, (B, S))), cache,
                     _plan(pname))
    key = f"{cname}/{pname}"
    _assert_within_one_bf16_ulp(out.logits, arrays[f"{key}/prefill"])
    _check_cache(arrays, f"{key}/prefill_cache", out.cache["sub_0"])


def test_int8_init_cache_has_the_reference_fields():
    cache = TT.init_cache(TINY.with_(kv_cache_dtype="int8",
                                     sliding_window=4), 3, 16,
                          device="cpu")["sub_0"]
    n, hd = TINY.num_layers, TINY.resolved_head_dim()
    kvp = TA.head_layout(TINY.num_heads, TINY.num_kv_heads, 1).KVp
    assert cache._fields == FIELDS
    assert cache.k.shape == (n, 3, 4, kvp, hd) and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == (n, 3, 4, kvp, 1)
    assert torch.equal(cache.k_scale, torch.ones_like(cache.k_scale))
    assert cache.pos.shape == (n,) and not cache.pos.any()
    plain = TT.init_cache(TINY, 3, 16, device="cpu")["sub_0"]
    assert plain.k.dtype == torch.bfloat16 and plain.k_scale is None
    assert not plain.quantized


# ---------------------------------------------------------------------------
# decode against the dense cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_decode_steps_equal_the_reference(ref, cname, pname):
    arrays, params = ref
    cfg = TINY.with_(**CONFIGS[cname])
    cache = TT.init_cache(cfg, B, T_LEN, device="cpu")
    cache = TT.prefill(params, cfg, torch.as_tensor(_tokens(0, (B, S))),
                       cache, _plan(pname)).cache
    key = f"{cname}/{pname}"
    for i, tok in enumerate(_tokens(1, (STEPS, B, 1))):
        assert int(TT.cache_position(cfg, cache)) == S + i
        out = TT.decode_step(params, cfg, torch.as_tensor(tok), cache,
                             _plan(pname))
        cache = out.cache
        _assert_within_one_bf16_ulp(out.logits, arrays[f"{key}/decode"][i])
    _check_cache(arrays, f"{key}/decode_cache", cache["sub_0"])


def test_ring_slots_past_the_cache_length():
    """Under a sliding window the decode write goes to ``pos % t``; without
    one it stays at ``min(pos, t - 1)``, and ``valid`` covers the slots
    written so far."""
    for window, want in ((4, [1, 2, 3, 0, 1]), (0, [5, 6, 7, 7, 7])):
        cfg = TINY.with_(sliding_window=window)
        t = 4 if window else 8
        for pos, slot in zip(range(5, 10), want):
            assert int(TA.decode_slot(cfg, torch.tensor(pos,
                                                        dtype=torch.int32),
                                      t)) == slot


# ---------------------------------------------------------------------------
# row-wise int8 quantization
# ---------------------------------------------------------------------------
def _rows(m, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)) * rng.uniform(0.01, 30, size=(m, 1))
    x[0] = 0.0                                   # an all-zero row: 1e-8 floor
    return x.astype(np.float32), torch.from_numpy(
        x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(64, 128), (8192, 128), (37, 96), (1, 5)])
def test_rowwise_quant_plain_equals_jitted_reference_and_pallas(m, k, dtype):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops, ref as jref
    _, x = _rows(m, k, dtype)
    jx = jnp.asarray(x.float().numpy())
    if dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    before = tquant.rowwise_quant.launches
    q, s = tquant.rowwise_quant(x)            # CPU: the plain version
    assert tquant.rowwise_quant.launches == before
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (m, k) and s.shape == (m, 1)
    wq, ws = jax.jit(jref.rowwise_quant_ref)(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    pq, ps = ops.rowwise_quant(jx)            # Pallas, interpret mode
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ps))


@pytest.mark.parametrize("shape", [(8, 1, 8, 128), (8, 128, 8, 128),
                                   (3, 5, 2, 16)])
def test_cache_quant_is_bit_exact_with_the_jitted_reference(shape):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    rng = np.random.default_rng(4)
    x = (rng.normal(size=shape) * rng.uniform(0.1, 8, size=shape[:-1] + (1,))
         ).astype(np.float32)
    tx = torch.from_numpy(x).bfloat16()
    q, s = tquant.rowwise_quant(tx.reshape(-1, shape[-1]))   # CPU: plain
    q, s = q.reshape(shape), s.reshape(*shape[:-1], 1)
    wq, ws = jax.jit(JA._cache_quant)(jnp.asarray(x).astype(jnp.bfloat16))
    assert q.shape == shape and s.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    deq = TA._cache_deq(q, s)
    np.testing.assert_array_equal(deq.numpy(),
                                  np.asarray(JA._cache_deq(wq, ws)))


def test_rowwise_quant_scale_is_the_reciprocal_product():
    """Eager true division by 127 gives other scales on some rows; the
    kernel and its plain version multiply by f32(1/127) as XLA's jit
    does."""
    xf, x = _rows(4096, 128, torch.bfloat16, seed=9)
    amax = x.float().abs().amax(-1, keepdim=True).clamp_min(1e-8)
    _, s = tquant.rowwise_quant_plain(x)
    assert torch.equal(s, amax * tquant.INV_QMAX)
    assert not torch.equal(s, amax / 127.0)


def test_rowwise_quant_wrapper_rejects_what_it_does_not_take():
    with pytest.raises(ValueError):
        tquant.rowwise_quant(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        tquant.rowwise_quant(torch.zeros(2, 3, dtype=torch.int8))


# ---------------------------------------------------------------------------
# the fused int8 KV write (the CPU side of ``rowwise_quant_into``)
# ---------------------------------------------------------------------------
# (mode, sliding window, cache length t, decode position or prefill length):
# decode at a plain slot, at the clamped last slot (pos >= t, no window)
# and at ring slots (pos % t); prefill with s < t, s == t and s > t
KV_WRITES = [("decode", 0, 14, 3), ("decode", 0, 14, 20),
             ("decode", 4, 4, 5), ("decode", 4, 4, 11),
             ("prefill", 0, 14, 8), ("prefill", 4, 4, 4),
             ("prefill", 4, 4, 10), ("prefill", 0, 6, 15)]


def _kv_write_case(mode, t, pos_or_s, seed):
    """bf16 k/v of one step, and an int8 cache already holding random codes
    and scales (a write must touch its slots and no other)."""
    rng = np.random.default_rng(seed)
    s = 1 if mode == "decode" else pos_or_s
    kv = [(rng.normal(size=(B, s, TINY.num_kv_heads, 16))
           * rng.uniform(0.1, 8, size=(B, s, TINY.num_kv_heads, 1))
           ).astype(np.float32) for _ in range(2)]
    codes = [rng.integers(-127, 128, (B, t, TINY.num_kv_heads, 16)
                          ).astype(np.int8) for _ in range(2)]
    scales = [rng.uniform(0.01, 1, (B, t, TINY.num_kv_heads, 1)
                          ).astype(np.float32) for _ in range(2)]
    pos = pos_or_s if mode == "decode" else 0
    return kv, codes, scales, np.array(pos, np.int32)


@pytest.mark.parametrize("mode,window,t,pos_or_s", KV_WRITES)
def test_int8_kv_write_equals_the_reference(monkeypatch, mode, window, t,
                                            pos_or_s):
    """The port's decode step and prefill write their int8 KV through
    ``rowwise_quant_into`` (its plain version on the CPU); given the same
    bf16 k and v, the cache they leave (codes, scales, ``pos``) equals the
    jitted reference's bit for bit."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import transformer as JT
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense
    (k, v), codes, scales, pos = _kv_write_case(mode, t, pos_or_s, seed=t)
    kw = dict(kv_cache_dtype="int8", sliding_window=window)
    jcfg, tcfg = tiny_dense(**kw), TINY.with_(**kw)
    s, hd = k.shape[1], 16
    d, h = TINY.d_model, TINY.num_heads

    # the reference: its own write, k and v handed in for its projection
    def jrun(jk, jv, cache):
        q = jnp.zeros((B, s, h, hd), jk.dtype)
        monkeypatch.setattr(JA, "_project_qkv", lambda *a: (q, jk, jv))
        if mode == "prefill":
            return JT._prefill_kv(None, jcfg, None, None, cache, None)
        params = {"wo": jnp.zeros((h * hd, d), jnp.float32)}
        return JA.decode_attention_apply(params, jcfg,
                                         jnp.zeros((B, 1, d), jk.dtype),
                                         cache)[1]
    jcache = JA.KVCache(jnp.asarray(codes[0]), jnp.asarray(codes[1]),
                        jnp.asarray(pos), jnp.asarray(scales[0]),
                        jnp.asarray(scales[1]))
    want = jax.jit(jrun)(jnp.asarray(k, jnp.bfloat16),
                         jnp.asarray(v, jnp.bfloat16), jcache)

    tk, tv = (torch.from_numpy(a).bfloat16() for a in (k, v))
    cache = TA.KVCache(*(torch.from_numpy(a.copy()) for a in (
        codes[0], codes[1], pos, scales[0], scales[1])))
    before = tquant.rowwise_quant.launches
    if mode == "prefill":
        TT._prefill_kv(cache, tk, tv)
    else:
        q = torch.zeros((B, 1, h, hd), dtype=torch.bfloat16)
        monkeypatch.setattr(TA, "_project_qkv", lambda *a: (q, tk, tv))
        TA.decode_attention_apply({"wo": torch.zeros((h * hd, d))}, tcfg,
                                  torch.zeros((B, 1, d)).bfloat16(), cache)
    assert tquant.rowwise_quant.launches == before        # CPU: plain
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(cache, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_int8_kv_write_wrapper_rejects_what_it_does_not_take():
    k = torch.zeros(2, 1, 2, 16)
    buf = lambda *s_, dt=torch.int8: torch.zeros(*s_, dtype=dt)
    good = (buf(2, 4, 2, 16), buf(2, 4, 2, 16), buf(2, 4, 2, 1,
                                                    dt=torch.float32),
            buf(2, 4, 2, 1, dt=torch.float32))
    with pytest.raises(ValueError):            # k and v differ
        tquant.rowwise_quant_into(k, k[:, :, :1], *good)
    with pytest.raises(ValueError):            # cache of another width
        tquant.rowwise_quant_into(k, k, buf(2, 4, 2, 8), *good[1:])
    with pytest.raises(ValueError):            # decode writes one token
        tquant.rowwise_quant_into(torch.zeros(2, 2, 2, 16),
                                  torch.zeros(2, 2, 2, 16), *good,
                                  slot=torch.tensor(0, dtype=torch.int32))


if __name__ == "__main__":
    _reference(sys.argv[1])
