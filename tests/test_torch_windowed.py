"""The port's windowed serving loop against
``repro.runtime.serve.WindowedBaselineServer``, and the engine-or-windowed
fallback policy.

On ``rwkv6-smoke`` with the reference's weights, one seeded trace (three
windows, ``max_new`` of 0 and 1 among them, left-padded prompts) gives the
same greedy token streams and the same ``stats()`` counters under the
bf16 and "mpai" plans.  The same holds for the stacks the port once refused
(``engine_or_windowed`` on the same trace and weights from the reference):
``jamba-smoke`` (Mamba + attention + MoE, selective scan at prefill),
``tiny`` with a sliding window that bites (ring cache), ``tiny`` with int8
KV, a ``tiny`` Mamba hybrid — all through the windowed fallback — and a
``tiny`` MoE stack, which the engine now serves.  The reference runs in a
subprocess with XLA's excess precision off, so both sides round every bf16
op alike; the recurrences sum in another order (sequential vs associative
scan) and softplus differs in the last f32 bit, so a greedy pick could
part only at a near-tie of the top two logits (ROADMAP, "Greedy
near-ties").
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
from repro_torch.configs import jamba_v0_1_52b as tj
from repro_torch.configs import rwkv6_3b as tr
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.tiny import TINY
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.kernels import quant as tquant
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import wkv as twkv
from repro_torch.runtime.serve import (BatchingServer,
                                       ContinuousBatchingEngine, Request,
                                       WindowedBaselineServer,
                                       engine_or_windowed)

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("bf16", "mpai")
SERVER = dict(max_batch=3, prompt_len=8, max_len=20)


TIMING = ("decode_s", "admit_s")
# the stacks the port once refused, and ``jamba-smoke``
ONCE_REFUSED = ("sliding_window", "int8_kv", "mamba_hybrid", "moe",
                "jamba_smoke")
# stacks paged decode cannot serve, asked for hardened serving
HARDEN_FALLBACK = ("rwkv6", "jamba_smoke", "sliding_window", "int8_kv")


def _trace(vocab=512):
    rng = np.random.default_rng(3)
    return [(rid, rng.integers(0, vocab, int(rng.integers(1, 9))).astype(
                np.int32), max_new)
            for rid, max_new in enumerate([5, 0, 8, 1, 3, 7, 2])]


def _drive(server, request_cls, vocab=512):
    for rid, prompt, max_new in _trace(vocab):
        server.submit(request_cls(rid, prompt, max_new=max_new))
    steps = 0
    while server.pending:
        server.step()
        steps += 1
        assert steps < 200, "server made no progress"
    outputs = {str(rid): server.done[rid].output.tolist()
               for rid, _, _ in _trace(vocab)}
    stats = {k: v for k, v in server.stats().items() if k not in TIMING}
    return {"outputs": outputs, "stats": stats}


def _once_refused_cfg(name, tiny, moe_cls, jamba_smoke):
    """The config of case ``name`` in either package, given its ``tiny``
    (the reference's ``tests/conftest.py:tiny_dense``), ``MoEConfig`` and
    ``jamba-smoke``."""
    return {"sliding_window": tiny.with_(sliding_window=4),
            "int8_kv": tiny.with_(kv_cache_dtype="int8"),
            "mamba_hybrid": tiny.with_(mixer="hybrid", attn_every=2),
            "moe": tiny.with_(moe=moe_cls(num_experts=4, top_k=2,
                                          d_ff_expert=32)),
            "jamba_smoke": jamba_smoke}[name]


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

    from repro.configs import jamba_v0_1_52b as jj
    from repro.configs.base import MoEConfig as JMoE
    from repro.runtime.serve import engine_or_windowed as jeow
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    flat, kept = {}, {}

    def init(name, cfg):
        params = kept[name] = T.model_init(jax.random.PRNGKey(0), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            flat["/".join([name] + [p.key for p in path])] = np.asarray(leaf)
        return params

    def plan_of(cfg, pname):
        return (qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
                if pname == "mpai" else None)

    cfg = jr.SMOKE
    params = init("rwkv6", cfg)
    res = {"rwkv6": {}}
    for pname in PLANS:
        res["rwkv6"][pname] = _drive(JW(params, cfg, plan=plan_of(cfg, pname),
                                        **SERVER), JR)
    for name in ONCE_REFUSED:
        cfg = _once_refused_cfg(name, tiny_dense(), JMoE, jj.SMOKE)
        params = init(name, cfg)
        res[name] = {}
        for pname in PLANS:
            srv = jeow(params, cfg, plan=plan_of(cfg, pname),
                       max_slots=SERVER["max_batch"],
                       prompt_len=SERVER["prompt_len"],
                       max_len=SERVER["max_len"])
            res[name][pname] = {"server": type(srv).__name__,
                                **_drive(srv, JR, cfg.vocab_size)}
    res["harden"] = {}
    for name in HARDEN_FALLBACK:
        cfg = (jr.SMOKE if name == "rwkv6" else
               _once_refused_cfg(name, tiny_dense(), JMoE, jj.SMOKE))
        seen = []
        srv = jeow(kept[name], cfg, max_slots=SERVER["max_batch"],
                   prompt_len=SERVER["prompt_len"],
                   max_len=SERVER["max_len"], harden=True,
                   on_fallback=seen.append)
        res["harden"][name] = {"server": type(srv).__name__,
                               "fallbacks": len(seen)}
    np.savez(npz_path, **flat)
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
    res = json.loads((d / "ref.json").read_text())
    return ({"rwkv6": res.pop("rwkv6"), "harden": res.pop("harden"),
             **{f"once/{k}": v for k, v in res.items()}},
            bridge.to_torch(tree, "cpu"))


def _plan(pname):
    return (tqat.serve_plan(TPlan.mpai(tr.SMOKE.num_layers))
            if pname == "mpai" else None)


@pytest.mark.parametrize("pname", PLANS)
def test_windowed_streams_and_counters_equal_the_reference(ref, pname):
    want, params = ref[0]["rwkv6"][pname], ref[1]["rwkv6"]
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
    server = WindowedBaselineServer(ref[1]["rwkv6"], tr.SMOKE, device="cpu",
                                    **SERVER)
    windows, before = 0, twkv.wkv.launches
    for rid, prompt, max_new in _trace():
        server.submit(Request(rid, prompt, max_new=max_new))
    while server.pending:
        windows += server.occupancy == 0      # this step starts a window
        server.step()
    assert windows == -(-len(_trace()) // SERVER["max_batch"])
    assert twkv.wkv.launches == before        # the CPU runs the plain version


def test_max_new_zero_and_one_finish_with_the_window_prefill(ref):
    server = WindowedBaselineServer(ref[1]["rwkv6"], tr.SMOKE, device="cpu",
                                    **SERVER)
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
    srv = engine_or_windowed(ref[1]["rwkv6"], tr.SMOKE, max_slots=3,
                             prompt_len=8, max_len=20, on_fallback=seen.append,
                             device="cpu")
    assert isinstance(srv, WindowedBaselineServer)
    assert len(seen) == 1 and isinstance(seen[0], ValueError)
    # no room to decode: the engine is not tried at all
    seen.clear()
    srv = engine_or_windowed(ref[1]["rwkv6"], tr.SMOKE, prompt_len=8,
                             max_len=8, on_fallback=seen.append, device="cpu")
    assert isinstance(srv, WindowedBaselineServer) and not seen


@pytest.mark.parametrize("name", HARDEN_FALLBACK)
def test_harden_falls_back_to_the_reference_server(ref, name):
    """Hardened serving is asked of a stack paged decode cannot serve: the
    engine's ``ValueError`` comes first, so ``engine_or_windowed`` falls
    back once to the reference's server (the windowed loop takes no
    ``harden``), where a pageable stack would serve hardened."""
    want = ref[0]["harden"][name]
    cfg = (tr.SMOKE if name == "rwkv6" else
           _once_refused_cfg(name, TINY, MoEConfig, tj.SMOKE))
    seen = []
    srv = engine_or_windowed(ref[1][name], cfg,
                             max_slots=SERVER["max_batch"],
                             prompt_len=SERVER["prompt_len"],
                             max_len=SERVER["max_len"], harden=True,
                             on_fallback=seen.append, device="cpu")
    assert want == {"server": "WindowedBaselineServer", "fallbacks": 1}
    assert type(srv).__name__ == want["server"]
    assert len(seen) == want["fallbacks"]
    assert isinstance(seen[0], ValueError)


def test_batching_server_is_a_deprecated_shim(ref):
    with pytest.warns(DeprecationWarning):
        srv = BatchingServer(ref[1]["rwkv6"], tr.SMOKE, max_batch=2,
                             prompt_len=8, max_len=16, device="cpu")
    assert isinstance(srv, WindowedBaselineServer)
    assert srv.max_batch == 2


@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("name", ONCE_REFUSED)
def test_once_refused_stacks_equal_the_reference(ref, name, pname):
    """``engine_or_windowed`` picks the reference's server for each stack
    (the windowed fallback, or the engine for the MoE attention stack) and
    gives its greedy streams and counters; the windowed runs go through the
    kernels' plain versions of the stack (selective scan for Mamba
    prefills, row-wise quant for every int8 KV write)."""
    want, params = ref[0][f"once/{name}"][pname], ref[1][name]
    cfg = _once_refused_cfg(name, TINY, MoEConfig, tj.SMOKE)
    plan = tqat.serve_plan(TPlan.mpai(cfg.num_layers)) if pname == "mpai" \
        else None
    seen = []
    srv = engine_or_windowed(params, cfg, plan=plan,
                             max_slots=SERVER["max_batch"],
                             prompt_len=SERVER["prompt_len"],
                             max_len=SERVER["max_len"],
                             on_fallback=seen.append, device="cpu")
    assert type(srv).__name__ == want["server"]
    assert len(seen) == (want["server"] == "WindowedBaselineServer")
    launches = (tss.selective_scan.launches, tquant.rowwise_quant.launches)
    got = _drive(srv, Request, cfg.vocab_size)
    assert got["outputs"] == want["outputs"], (
        "greedy streams differ: check the reference's top-2 logit margin at "
        "the first divergent token (ROADMAP, 'Greedy near-ties')")
    assert got["stats"] == want["stats"]
    for rid, _, max_new in _trace(cfg.vocab_size):
        assert len(got["outputs"][str(rid)]) == max_new
    # the CPU runs the plain versions: no kernel launch
    assert launches == (tss.selective_scan.launches,
                        tquant.rowwise_quant.launches)


def test_jamba_windows_scan_every_mamba_layer_and_quantize_int8_kv(ref):
    """Counted through the plain versions: one selective scan per Mamba
    layer per window, and two row-wise quantizations (k, v) per attention
    layer per prefill and per decode step of an int8-KV stack."""
    cfg = tj.SMOKE.with_(kv_cache_dtype="int8")
    calls = {"scan": 0, "quant": 0}
    real_scan = tss.selective_scan_plain
    real_quant = tquant.rowwise_quant_plain

    def scan(*a):
        calls["scan"] += 1
        return real_scan(*a)

    def quant(*a):
        calls["quant"] += 1
        return real_quant(*a)
    tss.selective_scan_plain, tquant.rowwise_quant_plain = scan, quant
    try:
        srv = WindowedBaselineServer(ref[1]["jamba_smoke"], cfg,
                                     device="cpu", **SERVER)
        _drive(srv, Request, cfg.vocab_size)
    finally:
        tss.selective_scan_plain, tquant.rowwise_quant_plain = (real_scan,
                                                                real_quant)
    windows = -(-len(_trace()) // SERVER["max_batch"])
    assert calls["scan"] == 7 * windows
    assert calls["quant"] == 2 * (windows + srv.stats()["decode_steps"])


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
