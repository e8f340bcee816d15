"""The port's continuous-batching engine against
``repro.runtime.serve.ContinuousBatchingEngine``: one seeded request trace
(more requests than slots, so admissions land mid-decode; a pool small
enough to defer admissions with OutOfBlocksError; over-bucket prompts that
admit by chunked prefill and share a prompt prefix; ``max_new`` of 0 and
1) gives the same greedy token streams, in the same emission order, and
the same ``stats()`` counters, under the bf16 and "mpai" plans.

The reference runs in a subprocess with XLA's excess precision off, so it
rounds every bf16 op as the port does (see ``test_torch_model.py``); the
streams are then identical.  Greedy picks can only part at a near-tie of
the top two logits (ROADMAP, "Greedy near-ties")."""
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


def _drive(engine, request_cls):
    events = []
    engine.on_token = lambda rid, tok: events.append([int(rid), int(tok)])
    for rid, prompt, max_new in _trace():
        engine.submit(request_cls(rid, prompt, max_new=max_new))
    steps = 0
    while engine.pending:
        engine.step()
        steps += 1
        assert steps < 500, "engine made no progress"
    outputs = {str(rid): engine.done[rid].output.tolist()
               for rid, _, _ in _trace()}
    stats = {k: v for k, v in engine.stats().items() if k not in TIMING}
    return {"outputs": outputs, "events": events, "stats": stats,
            "free_blocks": engine.alloc.available}


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_engine.py OUT.json OUT.npz``
# ---------------------------------------------------------------------------
def _reference(json_path, npz_path):
    import jax
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
    res = {}
    for pname in PLANS:
        plan = (qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))
                if pname == "mpai" else None)
        res[pname] = _drive(JE(params, cfg, plan=plan, **ENGINE), JR)
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


def test_what_is_not_ported_refuses_loudly(ref):
    params = ref[1]
    eng = _engine(params, "bf16")
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(0, np.zeros((0,), np.int32), max_new=2))
    with pytest.raises(NotImplementedError):
        eng.submit(Request(1, np.array([1, 2], np.int32), max_new=2,
                           sampling=SamplingParams(temperature=1.0)))
    eng.submit(Request(2, np.array([1, 2], np.int32), max_new=2,
                       sampling=SamplingParams()))      # greedy is fine
    with pytest.raises(NotImplementedError):
        eng.prefill_handoff(Request(3, np.array([1], np.int32)))
    with pytest.raises(NotImplementedError):
        _engine(params, "bf16", harden=True)
    with pytest.raises(ValueError):       # paged decode is attention-only
        ContinuousBatchingEngine(params, TINY.with_(mixer="mamba"),
                                 device="cpu", **ENGINE)
    with pytest.raises(AssertionError):   # prompt + max_new over max_len
        eng.submit(Request(4, np.arange(41, dtype=np.int32), max_new=1))


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
