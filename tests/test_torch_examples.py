"""The port's twins of five examples (``examples_torch/``) against the
reference's ``examples/``, on the CPU.

``route_failover`` and ``orbit_eclipse`` print what the reference
examples print, line for line.  ``serve_partitioned`` serves the
reference's seed-0 weights (bridged): the tokens of all ten requests
(greedy streams may part only at a near-tie of the port's top two
logits, ROADMAP "Greedy near-ties") and the handoff imports by shard
equal the reference's, and every line but the one with a wall-clock rate
is the same.  ``quickstart``'s scheduler lines equal the reference's, and
on the reference's init weights (the reference's ``Trainer`` fails on
jax 0.9, so no trained state exists to hold) its three eval losses lie
within 2 bf16 ulps of the reference's and its served stream is equal.
``train_100m``'s default config has the reference's parameter count, and
at tiny widths ``--steps 30 --inject-fault`` restarts once and ends
bit-equal to an uninterrupted run.  Every twin refuses to run without a
card unless given ``--device cpu``.

The reference runs once, in a subprocess (``python
tests/test_torch_examples.py OUT_DIR``): ``route_failover``,
``orbit_eclipse`` and ``serve_partitioned`` loaded from their files and
run, ``quickstart``'s steps written as the example writes them (its
``main`` stops in the ``Trainer``).  The twins run in-process with torch
at one thread.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "route_failover", "serve_partitioned",
         "orbit_eclipse", "train_100m")
QUICKSTART_ARCH = "stablelm-1.6b"
# a tiny train_100m: d 128 (2 heads of 64, 1 kv head), 2 layers
TINY_100M = ["--dmodel", "128", "--layers", "2", "--vocab", "512", "--seq",
             "32", "--batch", "2"]


def load(name: str, where: str = "examples_torch"):
    spec = importlib.util.spec_from_file_location(
        f"{where}_{name}", ROOT / where / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


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
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    return tree


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_examples.py OUT_DIR``
# ---------------------------------------------------------------------------
def _reference(out_dir):
    import runpy

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ShapeConfig
    from repro.core import qat
    from repro.core.cost_model import transformer_layer_costs
    from repro.core.partition import PartitionPlan
    from repro.core.scheduler import best_under_accuracy, schedule
    from repro.data.pipeline import lm_batch
    from repro.models import transformer as T
    from repro.serving import FleetSpec, PoolSpec

    out = Path(out_dir)
    res, arrays = {}, {}
    for name in ("route_failover", "orbit_eclipse"):
        path = str(ROOT / "examples" / f"{name}.py")
        sys.argv = [path]
        _, res[name] = captured(runpy.run_path, path, run_name="__main__")

    # serve_partitioned, with its seed-0 weights kept
    seen = []
    real_init = T.model_init

    def kept(*a, **kw):
        seen.append(real_init(*a, **kw))
        return seen[-1]

    T.model_init = kept
    try:
        mod = runpy.run_path(str(ROOT / "examples" / "serve_partitioned.py"))
        _, res["serve_partitioned"] = captured(mod["main"])
    finally:
        T.model_init = real_init
    _flatten(seen[0], "serve_partitioned", arrays)

    # quickstart: steps 1 and 2 print as the example does (its main stops
    # in the Trainer on jax 0.9), then steps 4 and 5 on the seed-0 init
    cfg = get_config(QUICKSTART_ARCH, smoke=True).with_(
        num_layers=4, d_model=128, d_ff=256, remat=False)
    shape = ShapeConfig("quickstart", 64, 8, "train")
    layers = transformer_layer_costs(cfg, shape.seq_len)
    chosen = best_under_accuracy(
        schedule(layers, ["tpu_v5e_int8", "tpu_v5e_bf16"],
                 accuracy_penalty={"tpu_v5e_int8": 0.05}),
        max_penalty=0.045)
    res["quickstart"] = (
        f"arch={cfg.name}  params~{cfg.param_count()/1e6:.1f}M\n"
        f"scheduler chose: {chosen.assignments} "
        f"-> {chosen.latency_s*1e3:.2f} ms model latency\n")
    plan = chosen.to_partition_plan(qat=True)
    params = T.model_init(jax.random.PRNGKey(0), cfg)
    _flatten(params, "quickstart", arrays)

    def eval_loss(plan_):
        tot = 0.0
        for s in range(3):
            b = lm_batch(cfg, shape, 10_000 + s)
            tot += float(T.loss_fn(params, cfg, b["tokens"], b["labels"],
                                   plan_))
        return tot / 3

    res["quickstart_losses"] = {
        "bf16": eval_loss(None), "mpai": eval_loss(qat.serve_plan(plan)),
        "ptq": eval_loss(PartitionPlan.int8_all(cfg.num_layers))}
    fleet = FleetSpec(
        pools=[PoolSpec("deploy", ("tpu_v5e_int8", "tpu_v5e_bf16"),
                        backend="engine", capacity=1, max_wait_s=0.0,
                        max_slots=2, prompt_len=8, max_new=8)],
        workload="transformer", arch=QUICKSTART_ARCH, seq_len=shape.seq_len)
    client = fleet.build(model=(cfg, params))
    prompt = lm_batch(cfg, shape, 42)["tokens"][0, :8]
    handle = client.submit(jnp.asarray(prompt), slo="offline", max_new=8)
    res["quickstart_stream"] = [int(t) for t in handle.stream()]
    (out / "ref.json").write_text(json.dumps(res))
    np.savez(out / "ref.npz", **arrays)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("examples_ref")
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return (json.loads((out / "ref.json").read_text()),
            dict(np.load(out / "ref.npz")))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread: the suite runs files in parallel
    workers, and a training loop on every core of a shared machine stalls
    them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bridged(arrays, prefix):
    from repro_torch import bridge
    return bridge.to_torch(_unflatten(arrays, prefix), "cpu")


# ---------------------------------------------------------------------------
# the cost-model fleets: stdout line for line
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["route_failover", "orbit_eclipse"])
def test_cost_model_twin_prints_what_the_reference_prints(ref, name):
    _, got = captured(load(name).main, ["--device", "cpu"])
    assert got.splitlines() == ref[0][name].splitlines()


# ---------------------------------------------------------------------------
# serve_partitioned on the reference's weights
# ---------------------------------------------------------------------------
RATE_LINE = "disaggregated serving:"      # carries decode tok/s (wall clock)


def _request_tokens(text):
    return {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"^  req +(\d+): prompt -> (\[.*\])$", text, re.M)}


def _near_tie_equal(cfg, params, plan, prompts, got, want, prompt_len):
    """Streams equal, or parting first at a near-tie (within 4 bf16 ulps
    of the top logit) of the port's top two logits over the left-padded
    prompt and the tokens before the split."""
    from repro_torch.models import transformer as T
    for rid, prompt in enumerate(prompts):
        a, b = got[rid], want[rid]
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        ctx = np.zeros(prompt_len, np.int32)
        ctx[-len(prompt):] = prompt
        ctx = np.concatenate([ctx, np.asarray(b[:t], np.int32)])
        logits = T.forward(params, cfg, torch.as_tensor(ctx[None]),
                           plan).logits[0, -1].float()
        top2 = torch.topk(logits, 2).values
        margin = float(top2[0] - top2[1])
        assert margin <= 2 ** -5 * abs(float(top2[0])), (
            f"request {rid} parts at token {t} ({a[t]} vs {b[t]}) with "
            f"top-2 margin {margin}")


def test_serve_partitioned_equals_the_reference(ref):
    want_text = ref[0]["serve_partitioned"]
    twin = load("serve_partitioned")
    cfg = twin.model_config()
    params = _bridged(ref[1], "serve_partitioned")
    (client, got_text) = captured(twin.build_fleet, cfg, params, "cpu")
    res, served_text = captured(twin.serve, client, cfg)
    got_text += served_text
    got, want = _request_tokens(got_text), _request_tokens(want_text)
    assert sorted(got) == list(range(10)) and sorted(want) == sorted(got)
    plan = client.engines["board"].decode.plan
    _near_tie_equal(cfg, params, plan, twin.prompts(cfg), got, want, 16)
    if got == want:
        keep = lambda text: [ln for ln in text.splitlines()
                             if not ln.startswith(RATE_LINE)]
        assert keep(got_text) == keep(want_text)
    imports = re.search(r"imports by shard (\{.*?\})", want_text).group(1)
    assert str(res["imports_by_shard"]) == imports


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(abs(float(x)))) - 7)


@pytest.fixture(scope="module")
def quickstart():
    twin = load("quickstart")
    cfg, text = captured(twin.model_config, QUICKSTART_ARCH)
    (chosen, plan), more = captured(twin.choose_plan, cfg)
    return twin, cfg, chosen, plan, text + more


def test_quickstart_scheduler_equals_the_reference(ref, quickstart):
    *_, text = quickstart
    want = ref[0]["quickstart"].splitlines()[:2]
    assert want[1].startswith("scheduler chose:")
    assert text.splitlines() == want


def test_quickstart_eval_losses_on_reference_weights(ref, quickstart):
    twin, cfg, _, plan, _ = quickstart
    params = _bridged(ref[1], "quickstart")
    losses, _ = captured(twin.evaluate, cfg, params, plan, device="cpu")
    for name, want in ref[0]["quickstart_losses"].items():
        assert abs(losses[name] - want) <= 2 * _bf16_ulp(want), (name,
                                                                 losses)


def test_quickstart_served_stream_on_reference_weights(ref, quickstart):
    twin, cfg, _, _, _ = quickstart
    params = _bridged(ref[1], "quickstart")
    stream, _ = captured(twin.serve, cfg, params, QUICKSTART_ARCH,
                         device="cpu")
    assert stream == ref[0]["quickstart_stream"]


# ---------------------------------------------------------------------------
# train_100m
# ---------------------------------------------------------------------------
def test_train_100m_default_config_has_the_references_parameters():
    from repro.configs import get_config
    want = get_config("qwen3-14b", smoke=True).with_(
        name="qwen3-100m", num_layers=12, d_model=640, num_heads=10,
        num_kv_heads=5, head_dim=64, d_ff=1920, vocab_size=50304,
        remat=False).param_count()
    cfg, text = captured(load("train_100m").model_config, 640, 12, 50304)
    assert cfg.param_count() == want
    assert text == f"model: {want/1e6:.1f}M params (12L d=640)\n"


def test_train_100m_restart_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    twin = load("train_100m")
    cfg, _ = captured(twin.model_config, 128, 2, 512)
    runs = {}
    for fault in (True, False):
        d = tmp_path / f"fault{fault}"
        runs[fault] = twin.train(cfg, 32, 2, 30, str(d), fault, "cpu")
    (a, hist_a, restarts_a), (b, hist_b, restarts_b) = runs[True], runs[False]
    assert (restarts_a, restarts_b) == (1, 0)
    assert int(a.step) == int(b.step) == 30
    assert hist_a == hist_b and [h["step"] for h in hist_a] == list(
        range(1, 31))
    from repro_torch.core.tree import tree_leaves
    for x, y in zip(tree_leaves((a.params, a.opt)),
                    tree_leaves((b.params, b.opt))):
        assert torch.equal(x, y)


def test_train_100m_main_prints_the_references_lines(capsys):
    load("train_100m").main(["--steps", "2", "--device", "cpu",
                             *TINY_100M])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model: 0.5M params (2L d=128)"
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "1"],
                                                      ["step", "2"]]
    assert lines[-1].startswith("done: 2 steps, final loss ")


# ---------------------------------------------------------------------------
# every twin: on the card by default, refused without one
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_to_run_without_a_card(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        load(name).main([])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


if __name__ == "__main__":
    _reference(sys.argv[1])
