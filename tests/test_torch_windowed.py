"""The port's windowed serving loop against
``repro.runtime.serve.WindowedBaselineServer``, and the engine-or-windowed
fallback policy.

On ``rwkv6-smoke`` with the reference's weights, one seeded trace (three
windows, ``max_new`` of 0 and 1 among them, left-padded prompts) gives the
same greedy token streams and the same ``stats()`` counters under the
bf16 and "mpai" plans.  The reference runs in a subprocess with XLA's
excess precision off, so both sides round every bf16 op alike; the wkv
recurrence sums in another order (sequential vs associative scan), so a
greedy pick could part only at a near-tie of the top two logits (ROADMAP,
"Greedy near-ties").
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import rwkv6_3b as tr
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.tiny import TINY
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.kernels import wkv as twkv
from repro_torch.runtime.serve import (BatchingServer,
                                       ContinuousBatchingEngine, Request,
                                       WindowedBaselineServer,
                                       engine_or_windowed)

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("bf16", "mpai")
SERVER = dict(max_batch=3, prompt_len=8, max_len=20)
TIMING = ("decode_s",)


def _trace():
    rng = np.random.default_rng(3)
    return [(rid, rng.integers(0, 512, int(rng.integers(1, 9))).astype(
                np.int32), max_new)
            for rid, max_new in enumerate([5, 0, 8, 1, 3, 7, 2])]


def _drive(server, request_cls):
    for rid, prompt, max_new in _trace():
        server.submit(request_cls(rid, prompt, max_new=max_new))
    steps = 0
    while server.pending:
        server.step()
        steps += 1
        assert steps < 200, "server made no progress"
    outputs = {str(rid): server.done[rid].output.tolist()
               for rid, _, _ in _trace()}
    stats = {k: v for k, v in server.stats().items() if k not in TIMING}
    return {"outputs": outputs, "stats": stats}


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_windowed.py OUT.json OUT.npz``
# ---------------------------------------------------------------------------
def _reference(json_path, npz_path):
    import jax
    from repro.configs import rwkv6_3b as jr
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T
    from repro.runtime.serve import Request as JR
    from repro.runtime.serve import WindowedBaselineServer as JW

    cfg = jr.SMOKE
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(p.key for p in path)] = np.asarray(leaf)
    np.savez(npz_path, **flat)
    res = {}
    for pname in PLANS:
        plan = (qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
                if pname == "mpai" else None)
        res[pname] = _drive(JW(params, cfg, plan=plan, **SERVER), JR)
    Path(json_path).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("windowed_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(d / "ref.json"),
                          str(d / "params.npz")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    tree = {}
    for key, a in np.load(d / "params.npz").items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return (json.loads((d / "ref.json").read_text()),
            bridge.to_torch(tree, "cpu"))


def _plan(pname):
    return (tqat.serve_plan(TPlan.mpai(tr.SMOKE.num_layers))
            if pname == "mpai" else None)


@pytest.mark.parametrize("pname", PLANS)
def test_windowed_streams_and_counters_equal_the_reference(ref, pname):
    want, params = ref[0][pname], ref[1]
    # the trace exercises what it claims to: several windows, and requests
    # that finish at prefill
    assert len(_trace()) > 2 * SERVER["max_batch"]
    assert {0, 1} <= {max_new for _, _, max_new in _trace()}
    server = WindowedBaselineServer(params, tr.SMOKE, plan=_plan(pname),
                                    device="cpu", **SERVER)
    got = _drive(server, Request)
    assert got["outputs"] == want["outputs"], (
        "greedy streams differ: check the reference's top-2 logit margin at "
        "the first divergent token (ROADMAP, 'Greedy near-ties')")
    assert got["stats"] == want["stats"]
    for rid, _, max_new in _trace():
        assert len(got["outputs"][str(rid)]) == max_new


def test_windows_run_the_wkv_recurrence_per_layer(ref):
    server = WindowedBaselineServer(ref[1], tr.SMOKE, device="cpu", **SERVER)
    windows, before = 0, twkv.wkv.launches
    for rid, prompt, max_new in _trace():
        server.submit(Request(rid, prompt, max_new=max_new))
    while server.pending:
        windows += server.occupancy == 0      # this step starts a window
        server.step()
    assert windows == -(-len(_trace()) // SERVER["max_batch"])
    assert twkv.wkv.launches == before        # the CPU runs the plain version


def test_max_new_zero_and_one_finish_with_the_window_prefill(ref):
    server = WindowedBaselineServer(ref[1], tr.SMOKE, device="cpu", **SERVER)
    server.submit(Request(0, np.array([5], np.int32), max_new=1))
    server.submit(Request(1, np.array([5, 6], np.int32), max_new=0))
    done = server.step()
    assert sorted(r.rid for r in done) == [0, 1]
    assert server.done[0].output.shape == (1,)
    assert server.done[1].output.shape == (0,)
    assert server.stats()["total_tokens"] == 1
    assert server.stats()["decode_steps"] == 0


def test_engine_or_windowed_keeps_the_engine_for_a_dense_stack():
    seen = []
    srv = engine_or_windowed(None, TINY, max_slots=2, prompt_len=8,
                             max_len=16, block_size=4, on_fallback=seen.append,
                             device="cpu")
    assert isinstance(srv, ContinuousBatchingEngine) and not seen


def test_engine_or_windowed_falls_back_to_windowed_for_rwkv(ref):
    seen = []
    srv = engine_or_windowed(ref[1], tr.SMOKE, max_slots=3, prompt_len=8,
                             max_len=20, on_fallback=seen.append,
                             device="cpu")
    assert isinstance(srv, WindowedBaselineServer)
    assert len(seen) == 1 and isinstance(seen[0], ValueError)
    # no room to decode: the engine is not tried at all
    seen.clear()
    srv = engine_or_windowed(ref[1], tr.SMOKE, prompt_len=8, max_len=8,
                             on_fallback=seen.append, device="cpu")
    assert isinstance(srv, WindowedBaselineServer) and not seen


def test_batching_server_is_a_deprecated_shim(ref):
    with pytest.warns(DeprecationWarning):
        srv = BatchingServer(ref[1], tr.SMOKE, max_batch=2, prompt_len=8,
                             max_len=16, device="cpu")
    assert isinstance(srv, WindowedBaselineServer)
    assert srv.max_batch == 2


@pytest.mark.parametrize("cfg", [
    TINY.with_(sliding_window=4),
    TINY.with_(kv_cache_dtype="int8"),
    TINY.with_(mixer="hybrid", attn_every=2),
    TINY.with_(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32)),
], ids=["sliding_window", "int8_kv", "mamba_hybrid", "moe"])
def test_stacks_still_unported_are_refused(cfg):
    seen = []
    with pytest.raises(NotImplementedError, match="not ported yet"):
        engine_or_windowed(None, cfg, max_slots=2, prompt_len=8, max_len=16,
                           block_size=4, on_fallback=seen.append,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WindowedBaselineServer(None, cfg, device="cpu")


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
