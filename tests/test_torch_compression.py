"""The port's int8 gradient compression (``repro_torch.optim.compression``)
against ``repro.optim.compression``.

The reference runs ``compressed_grad_mean`` and ``ErrorFeedback.apply``
jitted under ``shard_map`` over 1, 2 and 4 forced host devices, in a
subprocess with XLA's excess precision off; the port runs them on as many
``torch.distributed`` gloo ranks, each a subprocess joined through a
``FileStore`` under ``tmp_path``, on the same per-rank numpy gradients
(a leaf padded to whole chunks, one of exactly four chunks, an all-zero
chunk and a leaf under ``CHUNK`` that goes uncompressed).  Every rank's
int8 codes and f32 scales are bit-equal to the reference's, the means and
the carried residuals within 2 f32 ulps, and on one rank the mean is the
quantize-dequantize round trip itself, bit for bit."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.optim.compression import (CHUNK, ErrorFeedback,
                                           _chunk_dequant, _chunk_quant)

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
SHAPES = {"w": (3, 1400), "v": (4, CHUNK), "z": (CHUNK,), "b": (8, 4)}
QUANTIZED = ("w", "v", "z")       # leaves of at least CHUNK elements


def _grads(rank: int):
    """Rank ``rank``'s gradients and error-feedback residuals."""
    rng = np.random.default_rng(10 + rank)
    g = {k: (rng.standard_normal(s) * (rank + 1)).astype(np.float32)
         for k, s in SHAPES.items()}
    g["z"][:] = 0.0
    r = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
         for k, s in SHAPES.items()}
    return g, r


def _flat(prefix, tree, out):
    for k, v in tree.items():
        out[f"{prefix}/{k}"] = np.asarray(v)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_compression.py ref OUT``
# ---------------------------------------------------------------------------
def _reference(out):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.optim import compression as jc

    if hasattr(jax, "shard_map"):
        shard_map = partial(jax.shard_map, check_vma=False)
    else:                                                  # pragma: no cover
        from jax.experimental.shard_map import shard_map as sm
        shard_map = partial(sm, check_rep=False)

    res = {}
    for world in WORLDS:
        mesh = Mesh(np.array(jax.devices()[:world]), ("pod",))
        per_rank = [_grads(r) for r in range(world)]
        g = {k: jnp.stack([p[0][k] for p in per_rank]) for k in SHAPES}
        r = {k: jnp.stack([p[1][k] for p in per_rank]) for k in SHAPES}

        @jax.jit
        @partial(shard_map, mesh=mesh, in_specs=(P("pod"), P("pod")),
                 out_specs=(P("pod"), P("pod"), P(), P(), P("pod")))
        def body(g, r):
            g = jax.tree.map(lambda a: a[0], g)
            r = jax.tree.map(lambda a: a[0], r)
            quant = {k: jc._chunk_quant(g[k]) for k in QUANTIZED}
            codes = {k: q[None] for k, (q, _) in quant.items()}
            scales = {k: s[None] for k, (_, s) in quant.items()}
            mean = jc.compressed_grad_mean(g, "pod")
            ef_mean, ef_res = jc.ErrorFeedback.apply(g, r, "pod")
            return (codes, scales, mean, ef_mean,
                    jax.tree.map(lambda a: a[None], ef_res))

        codes, scales, mean, ef_mean, ef_res = body(g, r)
        for rank in range(world):
            _flat(f"{world}/{rank}/codes", {k: v[rank]
                                            for k, v in codes.items()}, res)
            _flat(f"{world}/{rank}/scales", {k: v[rank]
                                             for k, v in scales.items()}, res)
            _flat(f"{world}/{rank}/ef_res", {k: v[rank]
                                             for k, v in ef_res.items()}, res)
        _flat(f"{world}/mean", mean, res)
        _flat(f"{world}/ef_mean", ef_mean, res)
    np.savez(out, **res)


# ---------------------------------------------------------------------------
# one port rank, run as ``python tests/test_torch_compression.py RANK WORLD
# DIR``
# ---------------------------------------------------------------------------
def _rank(rank: int, world: int, d: str):
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_grad_mean

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, "store"), world),
        rank=rank, world_size=world)
    try:
        g, r = (
            {k: torch.from_numpy(v) for k, v in t.items()}
            for t in _grads(rank))
        res = {}
        for k in QUANTIZED:
            q, s = _chunk_quant(g[k])
            res[f"codes/{k}"], res[f"scales/{k}"] = q.numpy(), s.numpy()
        _flat("mean", compressed_grad_mean(g), res)
        ef_mean, ef_res = ErrorFeedback.apply(g, r)
        _flat("ef_mean", ef_mean, res)
        _flat("ef_res", ef_res, res)
        np.savez(os.path.join(d, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def _env(extra_flags: str = ""):
    flags = (os.environ.get("XLA_FLAGS", "") + extra_flags).strip()
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    return dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
                PYTHONPATH=path)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("compression_ref") / "ref.npz"
    env = _env(f" --xla_force_host_platform_device_count={max(WORLDS)}"
               " --xla_allow_excess_precision=false")
    res = subprocess.run([sys.executable, __file__, "ref", str(out)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """``{world: [rank results]}``: every world's ranks run at once."""
    runs = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"compression_{world}")
        runs[world] = (d, [subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world), str(d)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(world)])
    out = {}
    for world, (d, procs) in runs.items():
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
        out[world] = [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]
    return out


def _ulps(got, want, n: int = 2):
    """Every element of ``got`` within ``n`` f32 ulps of ``want``."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return bool((err <= n * np.spacing(np.abs(want))).all())


@pytest.mark.parametrize("world", WORLDS)
def test_codes_and_scales_are_bit_equal(ref, port, world):
    for rank, got in enumerate(port[world]):
        for k in QUANTIZED:
            q, s = got[f"codes/{k}"], got[f"scales/{k}"]
            assert q.dtype == np.int8 and s.dtype == np.float32
            np.testing.assert_array_equal(q, ref[f"{world}/{rank}/codes/{k}"])
            assert s.tobytes() == ref[f"{world}/{rank}/scales/{k}"].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_compressed_grad_mean_equals_the_reference(ref, port, world):
    for got in port[world]:
        for k in SHAPES:
            want = ref[f"{world}/mean/{k}"]
            assert got[f"mean/{k}"].shape == want.shape
            assert _ulps(got[f"mean/{k}"], want), (world, k)
    # every rank holds the same mean
    for got in port[world][1:]:
        for k in SHAPES:
            np.testing.assert_array_equal(got[f"mean/{k}"],
                                          port[world][0][f"mean/{k}"])


@pytest.mark.parametrize("world", WORLDS)
def test_error_feedback_equals_the_reference(ref, port, world):
    for rank, got in enumerate(port[world]):
        for k in SHAPES:
            assert _ulps(got[f"ef_mean/{k}"], ref[f"{world}/ef_mean/{k}"])
            assert _ulps(got[f"ef_res/{k}"], ref[f"{world}/{rank}/ef_res/{k}"])
        assert not got["ef_res/b"].any()         # an uncompressed leaf


def test_one_rank_mean_is_the_round_trip(port):
    got = port[1][0]
    g, _ = _grads(0)
    for k in QUANTIZED:
        x = torch.from_numpy(g[k])
        rt = _chunk_dequant(*_chunk_quant(x), x.shape).numpy()
        assert got[f"mean/{k}"].tobytes() == rt.tobytes()
    assert got["mean/b"].tobytes() == g["b"].tobytes()


def test_compressed_mean_is_close_to_the_exact_mean(port):
    """``test_compressed_grad_mean_close_to_exact``'s bound, on 4 ranks."""
    exact = {k: np.mean([_grads(r)[0][k] for r in range(4)], axis=0)
             for k in SHAPES}
    got = port[4][0]
    for k in ("w", "v"):
        rel = (np.abs(got[f"mean/{k}"] - exact[k]).max()
               / np.abs(exact[k]).max())
        assert rel < 0.05, (k, rel)
    np.testing.assert_allclose(got["mean/b"], exact["b"], rtol=1e-5)


def test_error_feedback_init_is_f32_zeros():
    g = {"w": torch.ones(3, 5, dtype=torch.bfloat16), "b": torch.ones(2)}
    r = ErrorFeedback.init(g)
    assert r["w"].dtype == torch.float32 and r["w"].shape == (3, 5)
    assert not r["w"].any() and not r["b"].any()


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2])
    else:
        _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
