"""The port's serving facade against ``repro.serving`` on fleets that run a
model: a cost-model pool, engine pools under bf16 and "mpai" and a
windowed pool, built from the fleet JSON the reference wrote, with the
reference's weights (``tiny``, through ``repro_torch.bridge``) and one
seeded open loop of prompts, some longer than the engine pools'
``prompt_len`` bucket (chunked prefill).  Every request's admission,
serving pool, greedy tokens and per-token decode-step stamps equal the
reference's; the telemetry snapshot has the reference's keys at every
depth and the same values, except the engines' wall-clock floats, which
are named and left out.

Wall time enters the fleet's virtual clock: ``EngineExecutor.run``
returns its batch's measured seconds as the batch latency.  Both
packages' ``serving.executor`` therefore run under the same stub clock,
which advances a fixed step per reading, so completion times, SLO
verdicts and every dispatch decision that follows from them are
machine-independent.  The reference runs in a subprocess with XLA's
excess precision off, as in ``test_torch_engine.py``.

Also held to the reference: the engine's books after ``make_server``'s
warm-up (its second warm-up request is sampled in the reference and
greedy here), the windowed fallback of an ``rwkv6-smoke`` engine pool
(same warning, same tokens), and the fallback of a hardened pool whose
stack paged decode cannot serve.  What the port does not serve yet
raises ``NotImplementedError`` before any weights are touched."""
import json
import os
import subprocess
import sys
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.rwkv6_3b import SMOKE as RWKV
from repro_torch.configs.tiny import TINY
from repro_torch.models import transformer as T
from repro_torch.runtime.serve import (ContinuousBatchingEngine,
                                       WindowedBaselineServer)
from repro_torch.serving import (FaultSpec, FleetSpec, LMWork, PoolSpec,
                                 SamplingParams, executor, make_server,
                                 open_loop)

ROOT = Path(__file__).resolve().parents[1]
# engine wall-clock floats: the only values of a snapshot left uncompared
WALL_CLOCK = ("decode_s", "decode_tokens_per_s")
STEP_S = 0.05            # the stub clock's step: every batch's latency
N_COST, N_LM = 5, 24


class StubClock:
    """Stands in for ``time`` in ``serving.executor``: each reading
    advances a fixed step."""

    def __init__(self, step: float = STEP_S):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def fleet(Fleet, Pool):
    """The mixed fleet, in either package.  "lm-any" requests go to the
    cheapest plan (int8, the "mpai" engine pool); "lm-accurate" ones to
    bf16 plans, split by load between the bf16 engine pool and the
    windowed pool; "exact" (cost-model) requests to fp32 plans, which only
    the cost-model pool hosts.  The windowed pool's bucket holds the
    engine pools' longest prompt, so any LM pool can serve any request."""
    lm = dict(capacity=1, max_window=3, max_wait_s=0.01, max_slots=3,
              max_new=6)
    return Fleet(
        pools=[Pool("vision", ("tpu_v5e_fp32",), capacity=1, max_window=2),
               Pool("lm-mpai", ("tpu_v5e_int8",), backend="engine",
                    plan="mpai", prompt_len=8, block_size=4,
                    max_prompt_len=20, num_blocks=16, **lm),
               Pool("lm-bf16", ("tpu_v5e_bf16",), backend="engine",
                    prompt_len=8, block_size=4, max_prompt_len=20, **lm),
               Pool("lm-win", ("tpu_v5e_bf16",), backend="windowed",
                    prompt_len=24, **lm)],
        workload="transformer", seq_len=8,
        slos=[dict(name="lm-any", max_latency_s=600.0),
              dict(name="lm-accurate", max_latency_s=600.0,
                   max_accuracy_penalty=0.02),
              dict(name="exact", max_latency_s=600.0,
                   max_accuracy_penalty=0.0)])


def payload_fn(lmwork_cls, vocab=256):
    """Prompts of 1-8 tokens, one in four of 9-20 (over the engine
    pools' bucket); explicit ``max_new`` of 1-6 or the pool default."""
    def draw(rng):
        n = (int(rng.integers(9, 21)) if rng.random() < 0.25
             else int(rng.integers(1, 9)))
        prompt = rng.integers(0, vocab, n).astype(np.int32)
        if rng.random() < 0.3:
            return prompt
        return lmwork_cls(prompt, max_new=int(rng.integers(1, 7)))
    return draw


def serve(client, lmwork_cls, vocab=256, seed=5):
    """Cost-model requests at t=0, then the seeded LM open loop; returns
    what the comparison reads, and the LM requests' prompts in order."""
    draw, prompts = payload_fn(lmwork_cls, vocab), []

    def record(rng):
        work = draw(rng)
        prompts.append(np.asarray(getattr(work, "prompt", work)).tolist())
        return work
    cost = [client.submit(None, slo="exact") for _ in range(N_COST)]
    handles = open_loop(client, [client.resolve_slo("lm-any"),
                                 client.resolve_slo("lm-accurate")],
                        [0.5, 0.5], rate_hz=60.0, n_requests=N_LM,
                        seed=seed, payload_fn=record)
    return {"prompts": prompts, "truncated": handles.truncated,
            "handles": [{**h.telemetry, "tokens": h.tokens,
                         "token_steps": h.token_steps}
                        for h in cost + list(handles)],
            "snapshot": client.telemetry,
            "timeseries": client.timeseries.summary()}


def books(engine):
    """An engine's allocator free list and shared-block index."""
    sh = engine.shared
    return {"free": [int(b) for b in engine.alloc.free],
            "by_digest": sorted((d.hex(), int(b))
                                for d, b in sh._by_digest.items()),
            "refs": sorted((int(b), int(n)) for b, n in sh._refs.items()),
            "table": engine.table.tolist(),
            "lengths": engine.lengths.tolist()}


WARM_POOL = dict(name="w", profiles=("tpu_v5e_bf16",), backend="engine",
                 max_slots=2, prompt_len=8, block_size=4, max_prompt_len=16,
                 max_new=4)


def rwkv_fleet(Fleet, Pool, Fault, harden):
    return Fleet(pools=[Pool("rwkv", ("tpu_v5e_bf16",), backend="engine",
                             capacity=1, max_window=3, max_wait_s=0.0,
                             max_slots=3, prompt_len=8, max_new=5)],
                 workload="transformer", seq_len=8,
                 faults=([Fault("rwkv", at_s=1e6, kind="kv_bitflip")]
                         if harden else []))


def rwkv_prompts(vocab):
    rng = np.random.default_rng(9)
    return [rng.integers(0, vocab, int(rng.integers(1, 9))).astype(np.int32)
            for _ in range(5)]


def rwkv_serve(client, vocab):
    handles = [client.submit(p, slo="offline", max_new=1 + i % 5)
               for i, p in enumerate(rwkv_prompts(vocab))]
    # result(), not drain(): the hardened fleet's fault lies far ahead
    return [h.result().tokens.tolist() for h in handles]


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_facade_engine.py OUT_DIR``
# ---------------------------------------------------------------------------
def _reference(out):
    import jax
    from repro.configs import rwkv6_3b as jr
    from repro.models import transformer as JT
    from repro.serving import FaultSpec as JFault
    from repro.serving import FleetSpec as JFleet
    from repro.serving import LMWork as JWork
    from repro.serving import PoolSpec as JPool
    from repro.serving import executor as jexecutor
    from repro.serving import make_server as jmake_server
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    out = Path(out)
    flat = {}
    params = {}
    for name, cfg in (("tiny", tiny_dense()), ("rwkv", jr.SMOKE)):
        params[name] = JT.model_init(jax.random.PRNGKey(0), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                params[name])[0]:
            flat["/".join([name] + [p.key for p in path])] = np.asarray(leaf)
    np.savez(out / "params.npz", **flat)
    res = {}
    spec = fleet(JFleet, JPool)
    res["spec"] = spec.to_dict()
    jexecutor.time = StubClock()
    client = JFleet.from_dict(res["spec"]).build(
        model=(tiny_dense(), params["tiny"]))
    res["fleet"] = serve(client, JWork)
    srv = jmake_server(tiny_dense(), params["tiny"], JPool(**WARM_POOL))
    res["warm_books"] = books(srv)
    res["rwkv"] = {}
    for harden in (False, True):
        spec = rwkv_fleet(JFleet, JPool, JFault, harden)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            client = JFleet.from_dict(spec.to_dict()).build(
                model=(jr.SMOKE, params["rwkv"]))
        res["rwkv"][str(harden)] = {
            "spec": spec.to_dict(),
            "server": type(client.engines["rwkv"]).__name__,
            "warnings": [str(w.message) for w in seen],
            "tokens": rwkv_serve(client, jr.SMOKE.vocab_size)}
    (out / "ref.json").write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("facade_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(d)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    trees = {}
    for key, a in np.load(d / "params.npz").items():
        node = trees
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return (json.loads((d / "ref.json").read_text()),
            {k: bridge.to_torch(v, "cpu") for k, v in trees.items()})


@pytest.fixture(scope="module")
def served(ref):
    """The port's run of the reference's fleet JSON, on the CPU."""
    real = executor.time
    executor.time = StubClock()
    try:
        client = FleetSpec.from_dict(ref[0]["spec"]).build(
            model=(TINY, ref[1]["tiny"]), device="cpu")
        return client, serve(client, LMWork)
    finally:
        executor.time = real


def compare(got, want, path=""):
    """Same keys at every depth; every value equal but ``WALL_CLOCK``."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), path
        for k in want:
            if k not in WALL_CLOCK:
                compare(got[k], want[k], f"{path}/{k}")
        return
    assert got == want, (path, got, want)


def test_the_trace_exercises_every_pool(ref):
    want = ref[0]["fleet"]
    snap = want["snapshot"]
    assert not want["truncated"]
    assert snap["admitted"] == N_COST + N_LM == snap["completed"]
    pools = snap["pools"]
    for name in ("vision", "lm-mpai", "lm-bf16", "lm-win"):
        assert pools[name]["batches"] > 0, name
    # over-bucket prompts admitted by chunked prefill into both engine
    # pools (a bucket admission prefills exactly prompt_len tokens), and
    # the "mpai" pool's small block budget deferred admissions
    for name in ("lm-mpai", "lm-bf16"):
        assert pools[name]["prefill_tokens"] > 8 * pools[name]["completed"]
    assert pools["lm-mpai"]["deferrals"] > 0
    assert {h["pool"] for h in want["handles"][:N_COST]} == {"vision"}


def test_handles_tokens_and_pools_equal_the_reference(ref, served):
    got, want = served[1]["handles"], ref[0]["fleet"]["handles"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["rid"], g["admitted"], g["pool"]) == \
            (w["rid"], w["admitted"], w["pool"])
        assert g["tokens"] == w["tokens"], (
            f"request {w['rid']}: greedy streams differ; check the "
            f"reference's top-2 logit margin at the first divergent token "
            f"(ROADMAP, 'Greedy near-ties')")
        compare(g, w, f"handle {w['rid']}")


def test_snapshot_and_timeseries_equal_the_reference(ref, served):
    want = ref[0]["fleet"]
    compare(served[1]["snapshot"], want["snapshot"], "snapshot")
    compare(served[1]["timeseries"], want["timeseries"], "timeseries")
    assert served[1]["truncated"] == want["truncated"]
    assert served[1]["prompts"] == want["prompts"]


def test_lm_requests_return_their_budget(ref, served):
    client = served[0]
    for h in served[1]["handles"][N_COST:]:
        budget = 6
        assert len(h["tokens"]) <= budget and h["tokens"]
        assert all(0 <= t < TINY.vocab_size for t in h["tokens"])
    assert isinstance(client.engines["lm-mpai"], ContinuousBatchingEngine)
    assert isinstance(client.engines["lm-win"], WindowedBaselineServer)
    for eng in client.engines.values():
        assert eng.device == torch.device("cpu")


def test_warm_up_books_equal_the_reference(ref):
    srv = make_server(TINY, ref[1]["tiny"], PoolSpec(**WARM_POOL),
                      device="cpu")
    assert books(srv) == ref[0]["warm_books"]
    assert srv.alloc.available == srv.alloc.num_blocks
    assert srv.stats()["total_tokens"] == 0          # reset after warm-up


@pytest.mark.parametrize("harden", [False, True])
def test_rwkv_engine_pool_falls_back_as_the_reference(ref, harden):
    want = ref[0]["rwkv"][str(harden)]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        client = FleetSpec.from_dict(want["spec"]).build(
            model=(RWKV, ref[1]["rwkv"]), device="cpu")
    assert type(client.engines["rwkv"]).__name__ == want["server"] == \
        "WindowedBaselineServer"
    assert [str(w.message) for w in seen] == want["warnings"]
    assert len(want["warnings"]) == 1
    assert rwkv_serve(client, RWKV.vocab_size) == want["tokens"]


def _refused_specs():
    engine = dict(profiles=("tpu_v5e_bf16",), backend="engine", max_slots=2,
                  prompt_len=8, max_new=4)
    return {
        "prefill_backend": FleetSpec(pools=[PoolSpec(
            "p", prefill_backend="engine", **engine)], workload="transformer"),
        "pipeline_stages": FleetSpec(pools=[PoolSpec(
            "p", pipeline_stages=2, **engine)], workload="transformer"),
        "harden": FleetSpec(pools=[PoolSpec("p", harden=True, **engine)],
                            workload="transformer"),
        "data_plane_fault": FleetSpec(
            pools=[PoolSpec("p", **engine)], workload="transformer",
            faults=[FaultSpec("p", at_s=1.0, kind="slot_stall")]),
    }


@pytest.mark.parametrize("case", sorted(_refused_specs()))
def test_unported_paths_refuse_before_weights(case, monkeypatch):
    def no_init(*a, **k):
        raise AssertionError("weights were initialised before the refusal")
    monkeypatch.setattr(T, "model_init", no_init)
    spec = _refused_specs()[case]
    spec.arch = "qwen3-14b"
    spec.smoke = False                   # a full-width init would show
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        spec.build(device="cpu")
    pool = spec.pools[0]
    if case == "data_plane_fault":       # what build() makes of the target
        pool = replace(pool, harden=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_server(TINY, None, pool, device="cpu")


def test_sampled_submit_refuses_before_admission(ref):
    spec = FleetSpec(pools=[PoolSpec("lm", ("tpu_v5e_bf16",),
                                     backend="engine", max_slots=2,
                                     prompt_len=8, max_new=4)],
                     workload="transformer")
    client = spec.build(model=(TINY, ref[1]["tiny"]), device="cpu")
    prompt = np.array([3, 4, 5], np.int32)
    with pytest.raises(NotImplementedError, match="sampled"):
        client.submit(prompt, sampling=SamplingParams(temperature=1.0))
    with pytest.raises(NotImplementedError, match="sampled"):
        client.submit(LMWork(prompt, sampling=SamplingParams(temperature=0.7,
                                                             seed=3)))
    assert client.telemetry["admitted"] == 0
    h = client.submit(prompt, sampling=SamplingParams(), max_new=3)
    assert len(h.result().tokens) == 3          # greedy is served


def test_add_pool_builds_on_the_fleet_device(ref):
    spec = FleetSpec(pools=[PoolSpec("lm", ("tpu_v5e_bf16",),
                                     backend="engine", max_slots=2,
                                     prompt_len=8, max_new=4)],
                     workload="transformer")
    client = spec.build(model=(TINY, ref[1]["tiny"]), device="cpu")
    assert client.device == "cpu"
    client.add_pool(PoolSpec("lm-2", ("tpu_v5e_int8",), backend="engine",
                             plan="mpai", max_slots=2, prompt_len=8,
                             max_new=4))
    assert client.engines["lm-2"].device == torch.device("cpu")
    h = client.submit(np.array([7, 8], np.int32), max_new=2)
    assert len(h.result().tokens) == 2
    assert client.telemetry["pools_added"] == 1


def test_fleet_without_a_model_takes_the_ports_seeded_init():
    """No ``model=``: the arch registry and the port's seed-0 init (not
    the reference's weights) serve the pool; the same seed gives the same
    weights and so the same tokens."""
    spec = FleetSpec(pools=[PoolSpec("lm", ("tpu_v5e_bf16",),
                                     backend="engine", max_slots=2,
                                     prompt_len=8, max_new=3)],
                     workload="transformer", arch="qwen3-14b", smoke=True)
    runs = []
    for _ in range(2):
        client = spec.build(device="cpu")
        assert client.engines["lm"].cfg.name == "qwen3-smoke"
        runs.append(client.submit(np.array([1, 2, 3], np.int32))
                    .result().tokens.tolist())
    assert runs[0] == runs[1] and len(runs[0]) == 3


if __name__ == "__main__":
    _reference(sys.argv[1])
