"""The port's stage-axis decode pool (``repro_torch.serving.stage_executor.
StageAxisEngine``) against ``repro.serving.stage_executor``.

The reference runs in a subprocess on 2 forced host devices with XLA's
excess precision off, on ``qwen3-14b``'s smoke config cut to 4 layers (2
super-blocks a stage: the fake-quantized int8 backbone, then the bf16
tail and head); the port serves the same weights through
``repro_torch.bridge`` on the CPU.  Held equal: the tokens of
``tests/test_disagg.py``'s greedy trace and of a longer trace that queues
past the slots with half its requests sampled (greedy streams may part
only at a near-tie of the reference's top two logits, ROADMAP "Greedy
near-ties"; sampled ones are bit-equal through the threefry stream), every
``on_token`` event in order, and ``stats()`` (its keys, and every value but
the wall-clock ``decode_s`` / ``admit_s``).  The port's tokens equal its
own monolithic ``forward`` under the engine's plan; the refusals (three
stages, an odd super-block count, a prompt over the bucket) are the
reference's; and a ``PoolSpec(pipeline_stages=2)`` fleet serves through the
facade as the reference's does (``test_stage_axis_pool_via_fleetspec_
facade``), both packages on one stub clock."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import qwen3_14b as tq3
from repro_torch.models import transformer as T
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.serve import Request
from repro_torch.serving import FleetSpec, PoolSpec, executor, make_server
from repro_torch.serving.stage_executor import StageAxisEngine

ROOT = Path(__file__).resolve().parents[1]
TIMING = ("decode_s", "admit_s")
WALL_CLOCK = ("decode_s", "decode_tokens_per_s", "admit_s")
# name -> (engine geometry, trace seed, prompt lengths, max_new, sampled
# rids as (temperature, top_k, seed)); "greedy" is tests/test_disagg.py's
SCENARIOS = {
    "greedy": (dict(max_slots=2, prompt_len=8, max_len=12), 4,
               (3, 6, 8), (4, 4, 4), {}),
    "sampled": (dict(max_slots=3, prompt_len=8, max_len=16), 9,
                (5, 1, 8, 3, 7, 2), (6, 3, 8, 5, 1, 7),
                {0: (1.0, 0, 42), 2: (0.7, 8, -1), 3: (2.0, 50, 2**31 - 1),
                 5: (1.0, 1, 7)}),
}


def _cfg(pkg_configs):
    return pkg_configs.SMOKE.with_(num_layers=4, remat=False)


def _trace(name, vocab):
    _, seed, lens, max_new, _ = SCENARIOS[name]
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lens, max_new))]


def _drive(Engine, Req, Sampling, params, cfg, name, **kw):
    """Serve scenario ``name`` to the end; what the comparison reads."""
    geom, _, _, _, sampled = SCENARIOS[name]
    eng = Engine(params, cfg, num_stages=2, **geom, **kw)
    events = []
    eng.on_token = lambda rid, tok: events.append([int(rid), int(tok)])
    trace = _trace(name, cfg.vocab_size)
    for rid, prompt, max_new in trace:
        sp = (Sampling(*sampled[rid][:2], seed=sampled[rid][2])
              if rid in sampled else None)
        eng.submit(Req(rid, prompt, max_new=max_new, sampling=sp))
    while eng.pending:
        eng.step()
    st = eng.stats()
    return eng, {"outputs": {str(rid): eng.done[rid].output.tolist()
                             for rid, _, _ in trace},
                 "events": events, "keys": sorted(st),
                 "stats": {k: v for k, v in st.items() if k not in TIMING}}


class StubClock:
    """Stands in for ``time`` in ``serving.executor``: each reading
    advances a fixed step."""

    def __init__(self, step: float = 0.05):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def _facade(Fleet, Pool, cfg, params, **kw):
    """``test_stage_axis_pool_via_fleetspec_facade``'s fleet and requests:
    handles (telemetry and tokens) and the snapshot."""
    spec = Fleet(
        pools=[Pool("staged", ("tpu_v5e_bf16",), backend="engine",
                    capacity=1, max_window=4, max_wait_s=0.0, max_slots=2,
                    prompt_len=8, max_new=4, pipeline_stages=2)],
        workload="transformer", arch="qwen3-14b", seq_len=8)
    client = Fleet.from_dict(spec.to_dict()).build(model=(cfg, params), **kw)
    rng = np.random.default_rng(7)
    hs = [client.submit(rng.integers(0, cfg.vocab_size, 5).astype(np.int32),
                        slo="offline", max_new=3) for _ in range(3)]
    client.drain()
    return client, {"handles": [{**h.telemetry, "tokens": h.tokens}
                                for h in hs],
                    "snapshot": client.telemetry}


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_stage_executor.py OUT``
# ---------------------------------------------------------------------------
def _reference(out):
    import jax
    import jax.numpy as jnp
    from repro.configs import qwen3_14b as jq3
    from repro.models import transformer as JT
    from repro.runtime.sampling import SamplingParams as JS
    from repro.runtime.serve import Request as JR
    from repro.serving import FleetSpec as JFleet
    from repro.serving import PoolSpec as JPool
    from repro.serving import executor as jexecutor
    from repro.serving.stage_executor import StageAxisEngine as JEngine

    out = Path(out)
    cfg = _cfg(jq3)
    params = JT.model_init(jax.random.PRNGKey(0), cfg)
    flat = {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(out / "params.npz", **flat)
    res = {}
    for name in SCENARIOS:
        eng, res[name] = _drive(JEngine, JR, JS, params, cfg, name)
        # the top two logits behind every token of the reference's
        # streams, from the monolithic forward at [1, max_len]
        S = eng.max_len
        top2 = {}
        mono = jax.jit(lambda toks, plan=eng.plan: JT.forward(
            params, cfg, toks, plan=plan).logits)
        for rid, prompt, _ in _trace(name, cfg.vocab_size):
            seq, rows = list(map(int, prompt)), []
            for tok in res[name]["outputs"][str(rid)]:
                toks = np.zeros((1, S), np.int32)
                toks[0, :len(seq)] = seq
                logits = mono(jnp.asarray(toks))
                row = np.asarray(logits[0, len(seq) - 1], np.float32)
                rows.append(np.sort(row)[-2:][::-1].tolist())
                seq.append(tok)
            top2[str(rid)] = rows
        res[name]["top2"] = top2
    jexecutor.time = StubClock()
    _, res["facade"] = _facade(JFleet, JPool, cfg, params)
    (out / "ref.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("stage_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=2"
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(d)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    tree = {}
    for key, a in np.load(d / "params.npz").items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return json.loads((d / "ref.json").read_text()), \
        bridge.to_torch(tree, "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(ref):
    return {name: _drive(StageAxisEngine, Request, SamplingParams, ref[1],
                         _cfg(tq3), name, device="cpu")
            for name in SCENARIOS}


def _first_split(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tokens_equal_the_reference(ref, served, name):
    """Greedy streams equal, or part at a near-tie of the reference's top
    two logits (within 4 bf16 ulps of the top one) and are not compared
    past it; sampled streams equal."""
    want, got = ref[0][name], served[name][1]
    sampled = SCENARIOS[name][4]
    for rid, w in want["outputs"].items():
        g = got["outputs"][rid]
        assert len(g) == len(w)
        if int(rid) in sampled or g == w:
            assert g == w, f"sampled request {rid}: {g} vs {w}"
            continue
        t = _first_split(g, w)
        top, second = want["top2"][rid][t]
        assert top - second <= 2 ** -5 * abs(top), (
            f"request {rid} parts at token {t} ({g[t]} vs {w[t]}) with a "
            f"top-2 margin of {top - second}")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_events_and_stats_equal_the_reference(ref, served, name):
    want, got = ref[0][name], served[name][1]
    if got["outputs"] == want["outputs"]:
        assert got["events"] == want["events"]
    else:                    # a near-tie split: the same (rid, count) order
        assert [r for r, _ in got["events"]] == \
            [r for r, _ in want["events"]]
    assert got["keys"] == want["keys"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["num_stages"] == 2
    assert all(k in got["keys"] for k in TIMING)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tokens_equal_the_monolithic_forward(ref, served, name):
    """Greedy rows only: each token is the argmax of ``forward`` under the
    engine's plan on the prefix right-padded to ``max_len``."""
    eng, got = served[name]
    cfg, params = eng.cfg, ref[1]
    sampled = SCENARIOS[name][4]
    for rid, prompt, _ in _trace(name, cfg.vocab_size):
        if rid in sampled:
            continue
        seq = list(map(int, prompt))
        for tok in got["outputs"][str(rid)]:
            toks = torch.zeros((1, eng.max_len), dtype=torch.int32)
            toks[0, :len(seq)] = torch.tensor(seq)
            logits = T.forward(params, cfg, toks, plan=eng.plan).logits
            assert int(torch.argmax(logits[0, len(seq) - 1])) == tok, rid
            seq.append(tok)


def test_plan_is_the_fake_quantized_mpai_split(served):
    eng = served["greedy"][0]
    backbone, tail = eng.plan.segments
    assert (backbone.start, backbone.end, tail.end) == (0, 2, 4)
    assert backbone.policy.mode == "fake"
    assert tail.policy.mode == "raw"
    assert eng.devices == [torch.device("cpu")] * 2


def test_refusals_are_the_references(ref):
    cfg, params = _cfg(tq3), ref[1]
    with pytest.raises(ValueError, match="exactly 2 stages"):
        StageAxisEngine(params, cfg, num_stages=3, device="cpu")
    odd = cfg.with_(num_layers=3)
    with pytest.raises(ValueError, match="even super-block count"):
        StageAxisEngine(params, odd, device="cpu")
    eng = StageAxisEngine(params, cfg, max_slots=2, prompt_len=8,
                          max_len=12, device="cpu")
    with pytest.raises(ValueError, match="prompt_len bucket"):
        eng.submit(Request(0, np.arange(9, dtype=np.int32), max_new=2))
    with pytest.raises(AssertionError):
        eng.submit(Request(1, np.arange(8, dtype=np.int32), max_new=5))
    assert not eng.pending


def test_make_server_builds_a_stage_axis_engine(ref):
    pool = PoolSpec("staged", ("tpu_v5e_bf16",), backend="engine",
                    max_slots=2, prompt_len=8, max_new=4, pipeline_stages=2,
                    plan="mpai")
    srv = make_server(_cfg(tq3), ref[1], pool, device="cpu")
    assert isinstance(srv, StageAxisEngine) and srv.num_stages == 2
    assert srv.plan.segments[0].policy.mode == "fake"   # not the pool's plan
    assert srv.max_len == pool.max_len and srv.prompt_len == 8
    assert srv.stats()["total_tokens"] == 0       # reset after warm-up
    assert srv.done[-1].output.shape == (2,)      # the warm-up request


def test_facade_pool_serves_as_the_reference(ref):
    real = executor.time
    executor.time = StubClock()
    try:
        client, got = _facade(FleetSpec, PoolSpec, _cfg(tq3), ref[1],
                              device="cpu")
    finally:
        executor.time = real
    assert isinstance(client.engines["staged"], StageAxisEngine)
    want = ref[0]["facade"]
    assert len(got["handles"]) == len(want["handles"]) == 3
    for g, w in zip(got["handles"], want["handles"]):
        assert len(g["tokens"]) == 3
        assert g["tokens"] == w["tokens"]
        _compare(g, w, f"handle {w['rid']}")
    _compare(got["snapshot"], want["snapshot"], "snapshot")


def _compare(got, want, path=""):
    """Same keys at every depth; every value equal but the wall-clock
    ones."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k not in WALL_CLOCK:
                _compare(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, list) and want and isinstance(want[0], dict):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}[{i}]")
        return
    got = list(got) if isinstance(got, tuple) else got
    assert got == want, (path, got, want)


if __name__ == "__main__":
    _reference(sys.argv[1])
