"""The port's twins of the six examples (``examples_torch/``) against the
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
bit-equal to an uninterrupted run.  ``pose_estimation_mpai`` at
``--steps 2 --batch 4`` from the reference's seed-0 UrsoNet init
(bridged): its latency lines equal the reference's, its accuracy and
delta lines have the reference's format, each condition's loss, LOCE and
ORIE lie within bounds its tests state, and on the weights the reference
trained its heads on the reference's features give the reference's
outputs.  Every twin refuses to run without a card unless given
``--device cpu``.

The reference runs once, in a subprocess (``python
tests/test_torch_examples.py OUT_DIR``): ``route_failover``,
``orbit_eclipse``, ``serve_partitioned`` and ``pose_estimation_mpai``
loaded from their files and run, ``quickstart``'s steps written as the
example writes them (its ``main`` stops in the ``Trainer``).  The twins
run in-process with torch at one thread.
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

from test_torch_pose import _features

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "route_failover", "serve_partitioned",
         "orbit_eclipse", "train_100m", "pose_estimation_mpai")
QUICKSTART_ARCH = "stablelm-1.6b"
POSE_BATCH, POSE_EVAL_BATCHES = 4, 8
POSE_ARGS = ["--steps", "2", "--batch", str(POSE_BATCH)]
# the example's UrsoNet (examples/pose_estimation_mpai.py:33-34)
POSE_CFG = dict(name="example", image_hw=(96, 128), widths=(16, 32, 64),
                blocks_per_stage=1, fc_dim=128)
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
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
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
    from repro import pose
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

    # pose_estimation_mpai at POSE_ARGS, with its seed-0 init, each
    # condition's trained weights and its rows kept
    kept = {"init": [], "trained": [], "rows": []}
    real = {k: getattr(pose, k) for k in ("ursonet_init", "train_ursonet",
                                          "run_condition")}

    def kept_init(*a, **kw):
        kept["init"].append(real["ursonet_init"](*a, **kw))
        return kept["init"][-1]

    def kept_train(*a, **kw):
        params, hist = real["train_ursonet"](*a, **kw)
        kept["trained"].append(params)
        return params, hist

    def kept_row(*a, **kw):
        kept["rows"].append(real["run_condition"](*a, **kw))
        return kept["rows"][-1]

    pose.ursonet_init, pose.train_ursonet = kept_init, kept_train
    pose.run_condition = kept_row
    try:
        path = str(ROOT / "examples" / "pose_estimation_mpai.py")
        sys.argv = [path, *POSE_ARGS]
        _, res["pose_estimation_mpai"] = captured(runpy.run_path, path,
                                                  run_name="__main__")
    finally:
        for k, v in real.items():
            setattr(pose, k, v)
    _flatten(jax.tree.map(np.asarray, kept["init"][0]), "pose/init", arrays)
    for row, params in zip(kept["rows"], kept["trained"]):
        _flatten(jax.tree.map(np.asarray, params),
                 f"pose/trained/{row['condition']}", arrays)
    res["pose_rows"] = kept["rows"]
    # each condition's evaluation on its trained weights: each held-out
    # batch's pooled features (what reaches the first FC product) and its
    # loc and quat
    from repro.data.pipeline import pose_batch
    from repro.models import cnn
    cfg = cnn.UrsoNetConfig(**POSE_CFG)
    for row, params in zip(kept["rows"], kept["trained"]):
        _, _, sb, sh = pose.POLICIES[row["condition"]]
        fn = jax.jit(lambda p, im: _features(cnn, lambda: cnn.ursonet_apply(
            p, cfg, im, sb, sh)))
        for s in range(POSE_EVAL_BATCHES):
            b = pose_batch(POSE_BATCH, 10_000 + s, seed=1000,
                           image_hw=cfg.image_hw)
            for key, val in zip(("loc", "quat", "feat"),
                                fn(params, b["images"])):
                arrays[f"pose/eval/{row['condition']}/{s}/{key}"] = \
                    np.asarray(val.astype(jnp.float32))

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


def _listed(tree):
    """Dicts whose keys are all indices back into lists."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _listed(v) for k, v in tree.items()}
    if tree and all(k.isdigit() for k in tree):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def _bridged(arrays, prefix):
    from repro_torch import bridge
    return bridge.to_torch(_listed(_unflatten(arrays, prefix)), "cpu")


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
# pose_estimation_mpai on the reference's init
# ---------------------------------------------------------------------------
POSE_LOSS_REL = 2e-2          # tests/test_torch_pose.py's training losses
POSE_METRIC_REL = {"loce": 1e-2, "orie": 2e-2}
POSE_HEAD_TOL = dict(rtol=2 ** -6, atol=2 ** -8)
DELTA_LINES = (r"  PTQ degrades vs fp32:   dORIE=[+-]\d+\.\d\d deg",
               r"  MPAI recovers \(QAT\+bf16 head\): dORIE=[+-]\d+\.\d\d deg")
ACCURACY_LINE = (r"(fp32|int8_ptq|int8_qat|mpai) +LOCE=\d+\.\d{3} m  "
                 r"ORIE=\d+\.\d\d deg  \(train loss \d+\.\d{3}\)")


@pytest.fixture(scope="module")
def pose_twin(ref):
    """The twin's ``main`` at the reference's arguments on the CPU, its
    UrsoNet starting from the reference's seed-0 init (bridged)."""
    from repro_torch import pose
    from repro_torch.core.tree import tree_map
    init = _bridged(ref[1], "pose/init")
    real = pose.ursonet_init
    pose.ursonet_init = lambda *a, **kw: tree_map(torch.clone, init)
    try:
        res, text = captured(load("pose_estimation_mpai").main,
                             [*POSE_ARGS, "--device", "cpu"])
    finally:
        pose.ursonet_init = real
    return res, text.splitlines()


def _blocks(lines):
    """The latency table, the accuracy lines and the delta structure: the
    runs of lines between blank ones."""
    blocks, cur = [], []
    for ln in lines + [""]:
        if ln:
            cur.append(ln)
        elif cur:
            blocks.append(cur)
            cur = []
    return blocks


def test_pose_twin_latency_lines_equal_the_reference(ref, pose_twin):
    want = _blocks(ref[0]["pose_estimation_mpai"].splitlines())
    got = _blocks(pose_twin[1])
    assert len(got) == len(want) == 3
    assert got[0][0].startswith("=== latency (cost model")
    assert len(got[0]) == 2 + 6
    assert got[0] == want[0]


def test_pose_twin_prints_the_references_accuracy_and_delta_format(
        ref, pose_twin):
    for lines in (ref[0]["pose_estimation_mpai"].splitlines(),
                  pose_twin[1]):
        _, accuracy, deltas = _blocks(lines)
        assert accuracy[0] == ("=== accuracy (measured, synthetic pose "
                               "task) ===")
        assert [re.fullmatch(ACCURACY_LINE, ln).group(1)
                for ln in accuracy[1:]] == ["fp32", "int8_ptq", "int8_qat",
                                           "mpai"]
        assert deltas[0] == "Table-I delta structure:"
        assert all(re.fullmatch(p, ln) for p, ln in zip(DELTA_LINES,
                                                        deltas[1:3]))
        assert deltas[3:] == ["  (paper: DPU-alone ORIE 9.29 vs baseline "
                              "7.28; DPU+VPU 7.32)"]


def _pose_row(rows, cond):
    return next(r for r in rows if r["condition"] == cond)


@pytest.mark.parametrize("cond", ("fp32", "int8_ptq", "int8_qat", "mpai"))
def test_pose_twin_trains_each_condition_as_the_reference(ref, pose_twin,
                                                          cond):
    """Two steps of batch 4 from the same init, then 8 held-out batches of
    4.  The last step's loss within 2e-2 relative, as
    ``tests/test_torch_pose.py`` holds five training steps (bf16 and
    fake-quantized gradients, GroupNorm summed in another order).  LOCE
    within 1e-2 and ORIE within 2e-2 relative: the loss is the squared
    scaled location error plus ``4 (1 - (q . q_gt)^2)``, and two steps
    from init ORIE is ~130 deg (|q . q_gt| ~ 0.4), where ORIE's relative
    change is 0.95x that of the orientation term and LOCE's half that of
    the location term; so the drift the loss bound admits moves the
    metrics by no more.  The evaluation's own hazards are below that:
    ``test_pose_twin_heads_on_the_references_weights``."""
    got = _pose_row(pose_twin[0]["accuracy"], cond)
    want = _pose_row(ref[0]["pose_rows"], cond)
    loss = got["final_train_loss"]
    assert abs(loss - want["final_train_loss"]) <= POSE_LOSS_REL * abs(
        want["final_train_loss"]), (loss, want)
    for key, rel in POSE_METRIC_REL.items():
        assert abs(got[key] - want[key]) <= rel * abs(want[key]), (key, got,
                                                                   want)


@pytest.mark.parametrize("cond", ("fp32", "int8_ptq", "int8_qat", "mpai"))
def test_pose_twin_heads_on_the_references_weights(ref, cond):
    """The evaluation alone: the port's ``ursonet_apply`` on the weights
    the reference trained, over its 8 held-out batches.  Under ``fp32``
    (bf16 backbone) the pooled features within ``2**-6 |ref| + 2**-8`` and
    the whole network's LOCE and ORIE within 2**-8 relative: GroupNorm's
    f32 sums in another order than XLA's flip a bf16 ulp here and there,
    and a metric Lipschitz in loc and quat carries that relative error.
    An int8 backbone (the other three) quantizes each activation per
    tensor, so one flipped ulp moves a code and the codes after it: here
    the port's features part from the reference's by up to ~22x that
    tolerance, so those conditions are held stage by stage, as
    ``tests/test_torch_pose.py`` holds its int8 pairs: the heads on the
    reference's features.  The heads' loc and quat within ``2**-6 |ref| +
    2**-8`` (bf16 heads: products summed in another order); int8 heads bit
    for bit (the same bf16 features quantize to the same codes, the GEMM
    is exact and the rest elementwise f32); and the LOCE and ORIE of those
    outputs within 2**-8 relative of the reference's row (int8 heads:
    1e-6, the metrics' own f32 arithmetic)."""
    from repro_torch import pose
    from repro_torch.data.pipeline import pose_batch
    from repro_torch.models import cnn
    cfg = cnn.UrsoNetConfig(**POSE_CFG)
    params = _bridged(ref[1], f"pose/trained/{cond}")
    _, _, sb, sh = pose.POLICIES[cond]
    int8_backbone = sb.precision.is_quantized
    int8_head = sh.precision.is_quantized
    arrays = ref[1]
    whole, heads = [], []
    for s in range(POSE_EVAL_BATCHES):
        b = pose_batch(POSE_BATCH, 10_000 + s, seed=1000,
                       image_hw=cfg.image_hw, device="cpu")
        want = {k: arrays[f"pose/eval/{cond}/{s}/{k}"]
                for k in ("loc", "quat", "feat")}
        loc, q, feat = _features(cnn, lambda: cnn.ursonet_apply(
            params, cfg, b["images"], sb, sh))
        whole.append(cnn.pose_metrics(loc, q, b["loc"], b["quat"]))
        if not int8_backbone:
            np.testing.assert_allclose(feat.float().numpy(), want["feat"],
                                       **POSE_HEAD_TOL)
        hl, hq, _ = _features(cnn, lambda: cnn.ursonet_apply(
            params, cfg, b["images"], sb, sh), torch.from_numpy(
                want["feat"]).to(feat.dtype))
        for got, key in ((hl, "loc"), (hq, "quat")):
            if int8_head:
                np.testing.assert_array_equal(got.numpy(), want[key])
            else:
                np.testing.assert_allclose(got.numpy(), want[key],
                                           **POSE_HEAD_TOL)
        heads.append(cnn.pose_metrics(hl, hq, b["loc"], b["quat"]))
    row = _pose_row(ref[0]["pose_rows"], cond)
    mean = lambda ms, i: sum(float(m[i]) for m in ms) / len(ms)
    rel = 1e-6 if int8_head else 2 ** -8
    for i, key in enumerate(("loce", "orie")):
        assert abs(mean(heads, i) - row[key]) <= rel * row[key], (key, row)
        if not int8_backbone:
            assert abs(mean(whole, i) - row[key]) <= 2 ** -8 * row[key], (
                key, row)


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
