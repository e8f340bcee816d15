"""The global batch inside the model on a mesh that splits it: per-tensor
activation scales and MoE routing over the batch group
(``repro_torch/core/collectives.py``), and each rank's share of every
global microbatch, in the mesh ``Trainer``.

The reference's jitted step reads the whole batch: under the ``"mpai"``
plan a per-tensor activation scale is the global batch's absmax, and an
MoE layer chooses its dispatch path on the global token count and takes
its load-balancing loss over the global batch.  Each case runs on gloo
ranks (worlds of 2 and 4, subprocesses joined through a ``FileStore``,
torch at one thread a rank) and is held to the reference's unsharded step
(``jax.jit(make_step_fn(...))`` with no mesh on the global batch, in a
subprocess with XLA's excess precision off; the reference's own sharded
``Trainer`` fails on jax 0.9) and to the port's one-device ``Trainer``
(in a third subprocess), from the reference's ``model_init(PRNGKey(0))``
weights (``jamba-smoke``: the port's seeded init, held to the one-device
``Trainer`` only).

Tolerances are ``tests/test_torch_sharded_train.py``'s ``REF_TOL`` and
``ONE_TOL``: under ``"mpai"`` its bf16 level (loss 2**-7 and grad norm
5e-2 relative, parameters within 2.2 lr a step and 2e-3 on average),
under f32 its f32 levels.  The bf16 level barely tells a per-rank scale
apart (after three steps the parameters' mean |diff| was 2.3e-3 to
2.8e-3 with per-rank scales, against its 2e-3), so the step-1 loss under ``"mpai"`` is also held within 1e-5 relative
(``STEP1_REL``) of the one-device ``Trainer``'s and, for ``tiny_dense``,
the reference's: per-rank absmaxes part it by 5.0e-5 to 1.0e-4 in the
three dense cases (1.0e-4 on (2, 1); measured on the CPU), the global
ones by at most 8.6e-8 (2.2e-6 from the reference's).

``olmoe-smoke`` under ``"mpai"`` takes one step.  Its first step routes
every row as the one-device run does and its loss agrees within 7.6e-8;
from the second on, the bf16 rounding of the first step's gradient (summed
over other rows) moves near-tied router choices, and the port's own
one-device run is 2.4e-3 to 3.5e-3 on average from the reference's after
three steps, past the bf16 level's 2e-3 (measured on the CPU), so a second
step would hold the port to the reference, not the split to the whole.

Routing is observed where it happens: each process wraps
``moe._expert_ffn`` and records, for each call, the dispatch path (a
per-row buffer ``[B, E, C, D]`` or the flat one) and each row's dispatched
slots; a row's dropped slots are ``S * k`` less those.  ``olmoe-smoke`` at
B 4 x S 1024 (8 experts, top 2) is grouped on the global batch (``t * k``
8192) and would be flat on a rank's 4096 alone.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded_train import (ONE_TOL, REF_TOL, TC_KW,  # noqa: E402
                                      _axes, _cfg, _check, _env, _flatten,
                                      _params, _unflatten, _wait_for)

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import (MeshConfig, MoEConfig,  # noqa: E402
                                      ShapeConfig, TrainConfig)
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

SHAPES = {"small": (8, 32), "long": (4, 1024)}          # batch, seq
MOE_FLAT = dict(num_experts=4, top_k=2, d_ff_expert=64)
# name: (config, mesh, plan, grad_accum, steps, shape, held to the reference)
CASES = {
    "dense-2x1": ("dense", (2, 1), "mpai", 1, 3, "small", True),
    "dense-4x1": ("dense", (4, 1), "mpai", 1, 3, "small", True),
    "dense-2x1-ga2": ("dense", (2, 1), "mpai", 2, 3, "small", True),
    "moe-2x1": ("moe", (2, 1), "f32", 1, 3, "small", True),
    "olmoe-2x1": ("olmoe", (2, 1), "f32", 1, 3, "long", True),
    "olmoe-2x1-mpai": ("olmoe", (2, 1), "mpai", 1, 1, "long", True),
    "jamba-2x1": ("jamba", (2, 1), "f32", 1, 1, "small", False),
}
WORLDS = {w: [n for n, c in CASES.items() if c[1][0] == w] for w in (2, 4)}
MPAI = [n for n, c in CASES.items() if c[2] == "mpai"]
STEP1_REL = 1e-5
REFUSED_BATCH = 2            # global batch of (2, 1) with grad_accum 2


def _config(key, ga=1):
    from repro_torch.configs import get_config
    if key == "dense":
        return _cfg(grad_accum=ga)
    if key == "moe":
        return _cfg("moe", fsdp=False, moe=MoEConfig(**MOE_FLAT),
                    grad_accum=ga)
    return get_config({"olmoe": "olmoe-1b-7b",
                       "jamba": "jamba-v0.1-52b"}[key], smoke=True)


def _plan(pname, n):
    from repro_torch.core import qat
    from repro_torch.core.partition import PartitionPlan
    from repro_torch.core.precision import PrecisionPolicy
    if pname == "f32":
        return PartitionPlan.uniform(n, PrecisionPolicy.fp32())
    return qat.train_plan(PartitionPlan.mpai(n))


def _shape(key):
    b, s = SHAPES[key]
    return ShapeConfig("t", s, b, "train")


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_batch_split.py ref DIR``
# ---------------------------------------------------------------------------
def _reference(d):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.configs.base import ModelConfig as JConfig
    from repro.configs.base import MoEConfig as JMoE
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.core import qat as jqat
    from repro.core.partition import PartitionPlan as JPlan
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.data.pipeline import lm_batch as jbatch
    from repro.models import transformer as JT
    from repro.optim import adamw as jadamw
    from repro.runtime.train_loop import TrainState, make_step_fn

    def jcfg(key, ga=1):
        if key == "olmoe":
            return get_config("olmoe-1b-7b", smoke=True)
        cfg = _config(key, ga)
        kw = {k: getattr(cfg, k) for k in (
            "name", "family", "num_layers", "d_model", "num_heads",
            "num_kv_heads", "d_ff", "vocab_size", "remat", "fsdp",
            "grad_accum")}
        if key == "moe":
            kw["moe"] = JMoE(**MOE_FLAT)
        return JConfig(**kw)

    res = {}
    for key in ("dense", "moe", "olmoe"):
        init = jax.jit(lambda k, cfg=jcfg(key): JT.model_init(k, cfg))
        _flatten(init(jax.random.PRNGKey(0)), key, res)
    np.savez(os.path.join(d, "weights.tmp.npz"), **res)
    os.rename(os.path.join(d, "weights.tmp.npz"),
              os.path.join(d, "weights.npz"))
    w = dict(res)
    res = {}
    tc = JTrain(**TC_KW)
    done = {}
    for name, (key, _, pname, ga, steps, sk, ref) in CASES.items():
        run = (key, pname, ga, steps, sk)
        if not ref or run in done:
            if ref:
                for k, v in done[run].items():
                    res[f"{name}/{k}"] = v
            continue
        cfg = jcfg(key, ga)
        plan = JPlan.uniform(cfg.num_layers, JPolicy.fp32()) \
            if pname == "f32" else jqat.train_plan(JPlan.mpai(cfg.num_layers))
        b, s = SHAPES[sk]
        shape = JShape("t", s, b, "train")
        params = jax.tree_util.tree_map(jnp.asarray, _unflatten(w, key))
        step = jax.jit(make_step_fn(cfg, tc, plan, 1))
        state = TrainState(params, jadamw.init(params, jnp.float32),
                           jnp.zeros((), jnp.int32))
        out = {"loss": [], "grad_norm": []}
        for t in range(steps):
            state, m = step(state, jbatch(cfg, shape, t))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
        out = {k: np.array(v) for k, v in out.items()}
        _flatten(state.params, "params", out)
        done[run] = out
        for k, v in out.items():
            res[f"{name}/{k}"] = v
    np.savez(os.path.join(d, "ref.npz"), **res)


# ---------------------------------------------------------------------------
# the port: ``python tests/test_torch_batch_split.py one DIR`` (the
# one-device Trainer) and ``... RANK WORLD DIR`` (a rank)
# ---------------------------------------------------------------------------
def _spy_dispatch(calls: list):
    """Wraps ``moe._expert_ffn``: each call appends ``(per_row,
    dispatched)``, ``dispatched`` each row's filled slots of a per-row
    buffer, or the flat buffer's filled slots."""
    from repro_torch.models import moe
    real = moe._expert_ffn

    def spy(params, buf, *args):
        filled = buf.detach().ne(0).any(-1)
        per_row = buf.ndim == 4
        calls.append((per_row, filled.sum(dim=(1, 2)).tolist() if per_row
                      else [int(filled.sum())]))
        return real(params, buf, *args)
    moe._expert_ffn = spy


def _trainer(name, mesh):
    key, _, pname, ga, _, sk, _ = CASES[name]
    cfg = _config(key, ga)
    return ttrain.Trainer(cfg, _shape(sk), MeshConfig(mesh, _axes(mesh)),
                          TrainConfig(**TC_KW),
                          plan=_plan(pname, cfg.num_layers), device="cpu")


def _train(res, name, mesh, w, calls):
    key, _, _, _, steps, sk, _ = CASES[name]
    tr = _trainer(name, mesh)
    if key == "jamba":
        state = tr.init_state()
    else:
        # a copy: the Trainer updates its state in place, and the next
        # case starts from the same weights
        params = tree_map(torch.clone,
                          bridge.to_torch(_unflatten(w, key), "cpu"))
        state = ttrain.TrainState(params, adamw.init(params),
                                  torch.zeros((), dtype=torch.int32))
        if tr.state_shardings is not None:
            state = tr.state_shardings.shard(state)
    del calls[:]
    state, hist = tr.run(state, lambda s: lm_batch(tr.cfg, _shape(sk), s,
                                                   device="cpu"),
                         steps, log_every=1)
    res[f"{name}/loss"] = np.array([h["loss"] for h in hist])
    res[f"{name}/grad_norm"] = np.array([h["grad_norm"] for h in hist])
    full = state.params if tr.mesh is None \
        else tr.param_shardings.unshard(state.params)
    _flatten(full, f"{name}/params", res)
    res[f"{name}/per_row"] = np.array([c[0] for c in calls], dtype=bool)
    res[f"{name}/dispatched"] = np.array([c[1] for c in calls], dtype=object)


def _one(d):
    torch.set_num_threads(1)
    _wait_for(os.path.join(d, "weights.npz"))
    w = dict(np.load(os.path.join(d, "weights.npz")))
    calls, res = [], {}
    _spy_dispatch(calls)
    for name in CASES:
        _train(res, name, (1, 1), w, calls)
    np.savez(os.path.join(d, "one.npz"), **res)


def _rank(rank: int, world: int, d: str):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, f"store{world}"), world),
        rank=rank, world_size=world)
    try:
        _wait_for(os.path.join(d, "weights.npz"))
        w = dict(np.load(os.path.join(d, "weights.npz")))
        calls, res = [], {}
        _spy_dispatch(calls)
        for name in WORLDS[world]:
            _train(res, name, CASES[name][1], w, calls)
        if world == 2:
            try:
                ttrain.Trainer(_config("dense", 2),
                               ShapeConfig("t", 32, REFUSED_BATCH, "train"),
                               MeshConfig((2, 1), _axes((2, 1))),
                               TrainConfig(**TC_KW), device="cpu")
                res["refused"] = np.array("")
            except ValueError as e:
                res["refused"] = np.array(str(e))
        np.savez(os.path.join(d, f"w{world}_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, one-device, {world: [rank results]})``, all run at
    once."""
    d = tmp_path_factory.mktemp("batch_split")
    argvs = [["ref", str(d)], ["one", str(d)]] + [
        [str(r), str(world), str(d)] for world in WORLDS
        for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, *a], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    def load(name):
        return dict(np.load(d / name, allow_pickle=True))
    return (load("ref.npz"), load("one.npz"),
            {world: [load(f"w{world}_rank{r}.npz") for r in range(world)]
             for world in WORLDS})


def _got(runs, name):
    return runs[2][CASES[name][1][0]][0]


def _held(got, want, name, tol):
    _check(got[f"{name}/loss"], got[f"{name}/grad_norm"],
           _params(got, f"{name}/params"), want[f"{name}/loss"],
           want[f"{name}/grad_norm"], _params(want, f"{name}/params"), tol)


def _tol(name):
    """The tolerance level of a case's plan."""
    return "f32" if CASES[name][2] == "f32" else "bf16"


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[6]])
def test_mesh_steps_equal_the_reference(runs, name):
    _held(_got(runs, name), runs[0], name, REF_TOL[_tol(name)])


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_equal_the_one_device_trainer(runs, name):
    _held(_got(runs, name), runs[1], name, ONE_TOL[_tol(name)])


@pytest.mark.parametrize("name", MPAI)
def test_mpai_step_one_takes_the_global_batch_scales(runs, name):
    """The first step's loss under ``"mpai"`` within ``STEP1_REL`` of the
    one-device ``Trainer``'s (and, for ``tiny_dense``, the reference's):
    per-rank scales part it by 5.0e-5 to 1.0e-4 (module docstring)."""
    got = float(_got(runs, name)[f"{name}/loss"][0])
    wants = (runs[1], runs[0]) if CASES[name][0] == "dense" else (runs[1],)
    for want in wants:
        w = float(want[f"{name}/loss"][0])
        assert abs(got - w) <= STEP1_REL * w, (got, w)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_every_rank_holds_the_same_history(runs, world):
    for r, got in enumerate(runs[2][world]):
        for name in WORLDS[world]:
            for k in ("loss", "grad_norm"):
                np.testing.assert_array_equal(
                    got[f"{name}/{k}"], runs[2][world][0][f"{name}/{k}"])


@pytest.mark.parametrize("name", ["moe-2x1", "olmoe-2x1", "olmoe-2x1-mpai",
                                  "jamba-2x1"])
def test_ranks_route_their_rows_as_the_global_batch(runs, name):
    """Each rank takes the one-device run's dispatch path at every MoE call,
    and in a per-row buffer each of its rows fills the same slots as that
    row in the one-device run (the same count dropped); ``olmoe-smoke``
    is per-row, ``tiny`` MoE and ``jamba-smoke`` flat."""
    one = runs[1]
    want_rows, want_n = one[f"{name}/per_row"], one[f"{name}/dispatched"]
    per_row = CASES[name][0] == "olmoe"
    assert len(want_rows) and want_rows.all() == per_row \
        and want_rows.any() == per_row
    b, s = SHAPES[CASES[name][5]]
    ranks = runs[2][CASES[name][1][0]]
    part = b // len(ranks)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{name}/per_row"], want_rows)
        for have, want in zip(got[f"{name}/dispatched"], want_n):
            if per_row:
                assert list(have) == list(want)[r * part:(r + 1) * part]
            else:
                assert have[0] * len(ranks) == want[0]
    if per_row:
        k = 2                                   # olmoe-smoke's top_k
        dropped = s * k * b - sum(sum(n) for n in want_n[:1])
        assert dropped > 0


def test_a_microbatch_that_does_not_split_is_refused(runs):
    msg = str(runs[2][2][0]["refused"])
    assert "does not split evenly" in msg and "2 microbatches" in msg


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2])
    elif sys.argv[1] == "one":
        _one(sys.argv[2])
    else:
        _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
