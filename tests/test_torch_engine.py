"""The port's continuous-batching engine against
``repro.runtime.serve.ContinuousBatchingEngine``: one seeded request trace
(more requests than slots, so admissions land mid-decode; a pool small
enough to defer admissions with OutOfBlocksError; over-bucket prompts that
admit by chunked prefill and share a prompt prefix; ``max_new`` of 0 and
1) gives the same token streams, in the same emission order, and the same
``stats()`` counters, under the bf16 and "mpai" plans: greedy, and with
half the requests sampled (temperature, top-k, negative seeds; bucket and
chunked admissions).  Hardened runs (``harden=True``) with no fault, an
armed bit flip at two seeds, a stalled slot, and a scrub that finds an
upset while every live slot is stalled give the reference's tokens,
counters, quarantined blocks, digest store and allocator books.

The reference runs in a subprocess with XLA's excess precision off, so it
rounds every bf16 op as the port does (see ``test_torch_model.py``); the
streams are then identical.  Greedy picks can only part at a near-tie of
the top two logits (ROADMAP, "Greedy near-ties").  Under "mpai" the int8
activations are quantized per tensor across the batch, as in the
reference, so a row's tokens depend on its neighbours there: a bit flip's
replay (whose masked rows feed token 0) need not reproduce an unfaulted
run, and the port is held to the reference, not to the unfaulted run
(ROADMAP §3, "Reference faults")."""
import json
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
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.runtime.serve import ContinuousBatchingEngine, Request

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("bf16", "mpai")
ENGINE = dict(max_slots=3, prompt_len=8, max_len=40, block_size=4,
              num_blocks=14)
TIMING = ("decode_s", "admit_s")


def _trace():
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 256, 16).astype(np.int32)
    trace = []
    for rid, max_new in enumerate([5, 0, 8, 6, 1, 3, 7, 2, 4, 6, 1, 5]):
        if rid in (3, 4):     # over-bucket prompts sharing two whole chunks
            p = np.concatenate([prefix, rng.integers(0, 256, 4)])
        elif rid == 9:        # over-bucket, nothing to share
            p = rng.integers(0, 256, 13)
        else:
            p = rng.integers(0, 256, int(rng.integers(1, 9)))
        trace.append((rid, p.astype(np.int32), max_new))
    return trace


# the sampled half of the mixed trace: (temperature, top_k, seed) by rid;
# rids 3 and 9 admit by chunked prefill
SAMPLED = {0: (1.0, 8, 42), 2: (0.7, 0, -1), 3: (1.0, 0, 7),
           6: (2.0, 50, 2**31 - 1), 9: (0.5, 4, -2**31), 11: (1.0, 1, 3)}

# hardened scenarios: (engine step, method, argument) calls made before
# that step; "scrub" calls ``scrub(budget)`` between steps
HARDEN_ENGINE = dict(watchdog_steps=3)
SCENARIOS = {
    "quiet": [],
    "bitflip_3": [(4, "arm_bitflip", 3)],
    "bitflip_11": [(7, "arm_bitflip", 11)],
    "stall": [(1, "stall_slot", 0), (12, "unstall_slot", 0)],
    # every live slot stalled, so no decode step reads the upset block:
    # the scrub finds it
    "scrub": [(3, "stall_slot", 0), (3, "stall_slot", 1),
              (3, "stall_slot", 2), (4, "arm_bitflip", 5),
              (5, "scrub", 100), (6, "unstall_slot", 0),
              (6, "unstall_slot", 1), (6, "unstall_slot", 2)],
}


def _drive(engine, request_cls, sampling_cls=None, faults=()):
    """Serve the trace to the end; with ``sampling_cls`` the ``SAMPLED``
    requests sample.  ``faults`` are (step, method, argument) calls."""
    events = []
    engine.on_token = lambda rid, tok: events.append([int(rid), int(tok)])
    for rid, prompt, max_new in _trace():
        sp = (sampling_cls(*SAMPLED[rid][:2], seed=SAMPLED[rid][2])
              if sampling_cls is not None and rid in SAMPLED else None)
        engine.submit(request_cls(rid, prompt, max_new=max_new, sampling=sp))
    steps = 0
    while engine.pending:
        for at, method, arg in faults:
            if at == steps:
                getattr(engine, method)(arg)
        engine.step()
        steps += 1
        assert steps < 500, "engine made no progress"
    outputs = {str(rid): engine.done[rid].output.tolist()
               for rid, _, _ in _trace()}
    stats = {k: v for k, v in engine.stats().items() if k not in TIMING}
    return {"outputs": outputs, "events": events, "stats": stats,
            "free_blocks": engine.alloc.available,
            "books": {"free": [int(b) for b in engine.alloc.free],
                      "quarantined": sorted(int(b) for b in
                                            engine.alloc.quarantined),
                      "digests": sorted([int(b), int(d)] for b, d in
                                        engine.digests.items()),
                      "table": engine.table.tolist(),
                      "lengths": engine.lengths.tolist()}}


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_engine.py OUT.json OUT.npz``
# ---------------------------------------------------------------------------
def _reference(json_path, npz_path):
    import jax
    # synchronous dispatch: the reference's replay loop writes the next
    # token into the host array the previous, still-queued decode call may
    # read without a copy (``_replay_generation``), which makes recovery
    # nondeterministic under asynchronous dispatch (ROADMAP §3)
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T
    from repro.runtime.serve import ContinuousBatchingEngine as JE
    from repro.runtime.serve import Request as JR
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import tiny_dense

    cfg = tiny_dense()
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        flat["/".join(p.key for p in path)] = np.asarray(leaf)
    np.savez(npz_path, **flat)
    from repro.runtime.sampling import SamplingParams as JS
    res = {}
    for pname in PLANS:
        plan = (qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
                if pname == "mpai" else None)
        res[pname] = _drive(JE(params, cfg, plan=plan, **ENGINE), JR)
        res[f"{pname}/sampled"] = _drive(JE(params, cfg, plan=plan, **ENGINE),
                                         JR, JS)
        for name, faults in SCENARIOS.items():
            eng = JE(params, cfg, plan=plan, harden=True,
                     **ENGINE, **HARDEN_ENGINE)
            res[f"{pname}/harden/{name}"] = _drive(eng, JR, JS, faults)
    Path(json_path).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("engine_ref")
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


def _engine(params, pname, **kw):
    plan = tqat.serve_plan(TPlan.mpai(2)) if pname == "mpai" else None
    return ContinuousBatchingEngine(params, TINY, plan=plan, device="cpu",
                                    **{**ENGINE, **kw})


@pytest.mark.parametrize("pname", PLANS)
def test_trace_streams_and_counters_equal_the_reference(ref, pname):
    want, params = ref[0][pname], ref[1]
    # the trace exercises what it claims to
    st = want["stats"]
    assert st["deferrals"] > 0 and st["shared_block_hits"] > 0
    assert len(want["outputs"]) > ENGINE["max_slots"]
    got = _drive(_engine(params, pname), Request)
    assert got["outputs"] == want["outputs"], (
        "greedy streams differ: check the reference's top-2 logit margin at "
        "the first divergent token (ROADMAP, 'Greedy near-ties')")
    assert got["events"] == want["events"]
    assert got["stats"] == want["stats"]
    assert got["free_blocks"] == want["free_blocks"] == ENGINE["num_blocks"]
    for rid, _, max_new in _trace():
        assert len(got["outputs"][str(rid)]) == max_new


@pytest.mark.parametrize("order", [[0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0],
                                   [3, 0, 5, 1, 4, 2]])
def test_outputs_do_not_depend_on_admission_order(ref, order):
    params = ref[1]
    trace = _trace()[:6]
    solo = {}
    for rid, prompt, max_new in trace:
        eng = _engine(params, "bf16", max_slots=1)
        eng.submit(Request(rid, prompt, max_new=max_new))
        eng.flush()
        solo[rid] = eng.done[rid].output.tolist()
    eng = _engine(params, "bf16")
    for i in order:
        rid, prompt, max_new = trace[i]
        eng.submit(Request(rid, prompt, max_new=max_new))
    while eng.pending:
        eng.step()
    assert {rid: eng.done[rid].output.tolist() for rid, _, _ in trace} == solo
    assert eng.alloc.available == eng.alloc.num_blocks
    assert (eng.table == -1).all()


def test_max_new_zero_and_one_complete_at_admission(ref):
    eng = _engine(ref[1], "bf16")
    eng.submit(Request(0, np.array([5], np.int32), max_new=1))
    eng.submit(Request(1, np.array([5], np.int32), max_new=0))
    done = eng.step()
    assert sorted(r.rid for r in done) == [0, 1]
    assert eng.done[0].output.shape == (1,)
    assert eng.done[1].output.shape == (0,)
    assert eng.stats()["total_tokens"] == 1
    assert eng.stats()["decode_steps"] == 0


def _assert_run_equal(got, want):
    assert got["outputs"] == want["outputs"], (
        "streams differ: check the reference's top-2 margin at the first "
        "divergent token (ROADMAP, 'Greedy near-ties')")
    assert got["events"] == want["events"]
    assert got["stats"] == want["stats"]
    assert got["books"] == want["books"]
    for rid, _, max_new in _trace():
        assert len(got["outputs"][str(rid)]) == max_new


@pytest.mark.parametrize("pname", PLANS)
def test_sampled_trace_equals_the_reference(ref, pname):
    want, params = ref[0][f"{pname}/sampled"], ref[1]
    assert want["outputs"] != ref[0][pname]["outputs"]   # sampling shows
    got = _drive(_engine(params, pname), Request, SamplingParams)
    _assert_run_equal(got, want)
    assert got["free_blocks"] == ENGINE["num_blocks"]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("pname", PLANS)
def test_hardened_runs_equal_the_reference(ref, pname, scenario):
    want, params = ref[0][f"{pname}/harden/{scenario}"], ref[1]
    st = want["stats"]
    # each scenario exercises what it claims to
    if scenario == "quiet":
        assert all(st[k] == 0 for k in ("bitflips_detected",
                                        "blocks_quarantined",
                                        "watchdog_trips", "replays",
                                        "scrubbed_blocks"))
        assert want["outputs"] == ref[0][f"{pname}/sampled"]["outputs"]
    elif scenario == "stall":
        assert st["watchdog_trips"] >= 1 and st["replays"] >= 1
    else:
        assert st["bitflips_detected"] >= 1 and st["blocks_quarantined"] >= 1
        assert st["replays"] >= 1
    if scenario == "scrub":
        assert st["scrubbed_blocks"] > 0
    eng = _engine(params, pname, harden=True, **HARDEN_ENGINE)
    got = _drive(eng, Request, SamplingParams, SCENARIOS[scenario])
    _assert_run_equal(got, want)
    alloc = eng.alloc
    assert alloc.available + len(alloc.quarantined) == alloc.num_blocks


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_bf16_recovery_is_bit_exact(ref, scenario):
    """Under bf16 a row's logits and KV depend on that row alone, so a
    recovered (or stalled and replayed) run equals the unfaulted one."""
    params = ref[1]
    base = ref[0]["bf16/sampled"]["outputs"]
    eng = _engine(params, "bf16", harden=True, **HARDEN_ENGINE)
    assert _drive(eng, Request, SamplingParams,
                  SCENARIOS[scenario])["outputs"] == base


def test_sampled_request_is_batch_invariant_and_top_k_one_is_greedy(ref):
    """Under bf16 a sampled request's tokens are the same solo and packed
    with neighbours (its keys are its own seed and token index), and
    ``top_k=1`` draws the greedy tokens."""
    params = ref[1]
    packed = ref[0]["bf16/sampled"]["outputs"]
    greedy = ref[0]["bf16"]["outputs"]
    for rid, prompt, max_new in _trace():
        if rid not in SAMPLED:
            continue
        temp, top_k, seed = SAMPLED[rid]
        eng = _engine(params, "bf16")
        eng.submit(Request(rid, prompt, max_new=max_new,
                           sampling=SamplingParams(temp, top_k, seed)))
        while eng.pending:
            eng.step()
        assert eng.done[rid].output.tolist() == packed[str(rid)], rid
        if top_k == 1:
            assert packed[str(rid)] == greedy[str(rid)]


def test_what_is_not_ported_refuses_loudly(ref):
    params = ref[1]
    eng = _engine(params, "bf16")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(0, np.zeros((0,), np.int32), max_new=2))
    eng.submit(Request(2, np.array([1, 2], np.int32), max_new=2,
                       sampling=SamplingParams()))      # greedy is fine
    with pytest.raises(ValueError, match="empty prompt"):
        eng.prefill_handoff(Request(3, np.zeros((0,), np.int32)))
    ho = eng.prefill_handoff(Request(3, np.array([1], np.int32)))
    ho.block_size = 8                     # another pool geometry
    with pytest.raises(AssertionError, match="block geometry"):
        eng.import_prefill(Request(3, np.array([1], np.int32)), ho)
    with pytest.raises(ValueError):       # paged decode is attention-only
        ContinuousBatchingEngine(params, TINY.with_(mixer="mamba"),
                                 device="cpu", **ENGINE)
    with pytest.raises(AssertionError):   # prompt + max_new over max_len
        eng.submit(Request(4, np.arange(41, dtype=np.int32), max_new=1))


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
