"""Mamba and RWKV-6 mixers head-parallel on the model axis: each rank of the
model group (``core/collectives.py``) computes the time mix on its ``Hp /
tp`` heads, the channel mix on its ``d_ff / tp`` units and the Mamba mixer
on its ``d_inner / tp`` channels, with the wkv and selective-scan kernels
(their plain versions here) on those; held against the same functions on
one device, against the reference's unsharded jitted step and against the
port's one-device ``Trainer``.

Processes: the reference runs jitted (XLA's excess precision off) in two
subprocesses, one a config, each first writing its ``model_init(
PRNGKey(0))`` weights; one world of two gloo ranks, (1, 2), and one of
four, (2, 2), run as subprocesses joined through a ``FileStore`` under
``tmp_path`` (torch at one thread a rank); the one-device side runs in the
test process while they do.  Everything is computed once for the module.

Checked on (1, 2), against one device (the port's seeded init; inputs from
``numpy`` seeds):

* the Mamba mixer and the RWKV-6 time and channel mix: outputs, input
  gradients and every parameter gradient (the rank's parts put together)
  within ``F32_TOL``; under the ``"quant"`` plan (int8 GEMMs) the outputs
  bit-equal, since a column-parallel int8 product is the product's
  columns and a row-parallel one all-reduces its int32 accumulator;
* ``rwkv6-smoke`` and ``jamba-smoke`` forwards into a cache, then
  ``DECODE_STEPS`` decode steps: f32 logits within ``LOGITS_TOL``, the
  residual stream after every layer bit-identical on both model ranks
  under the f32 and the ``"mpai"`` serving plan, a rank's caches
  ``[B, Hp / tp, N, N]`` and ``[B, d_inner / tp, N]``;
* the windowed server refuses a model group; Mamba's ``in_proj`` re-laid
  to the rank's channels of its two halves and back round-trips, and a
  checkpoint saved on (1, 2) restores on one device bit-equal to the
  whole weights, in the reference's column order;
* a ``Trainer`` step's collectives (``launch.dryrun.counted_collectives``):
  no all-gather of a model-axis part of any leaf; over the model group
  only the receptance gathers and ``in_proj``'s two all-to-alls.

Steps: one step of each config under f32 and the training plan's fake
quantization (``"mpai"``) on (1, 2) and (2, 2), from the reference's
weights: loss and grad norm within ``REF_TOL`` of the reference's step
(``tests/test_torch_sharded_train.py``), and the step within
``STEP_TOL`` of the one-device ``Trainer``'s: that file's ``ONE_TOL``
levels, the gradient AdamW gets held leaf by leaf and the parameters'
mean error over the whole tree (one step, as ``test_rwkv_smoke_on_2x1``
there explains).

Tolerances: a row-parallel f32 product adds the same f32 terms as one
device in another order (a few ulps of the largest term), and so do the
all-reduced gradients of the replicated inputs.  The mixers' outputs,
input gradients and states agree within 1e-6 of their largest entry
(``F32_TOL``; measured 3.3e-7 at most), their parameters' gradients,
summed over the batch from inputs that differ so, within 1e-5
(``PARAM_GRAD_TOL``; measured 1.03e-6 at most, Mamba's ``dt_proj``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded_train import (REF_TOL, TC_KW,  # noqa: E402
                                      _env, _flatten, _params, _unflatten,
                                      _wait_for)

from repro_torch import bridge  # noqa: E402
from repro_torch import sharding as shard  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (MeshConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.core import collectives, qat  # noqa: E402
from repro_torch.core.partition import PartitionPlan  # noqa: E402
from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import lm_batch  # noqa: E402
from repro_torch.models import mamba as mam  # noqa: E402
from repro_torch.models import rwkv as rwk  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop as ttrain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = 2
MESH = MeshConfig((1, RANKS), ("data", "model"))
B, S = 8, 32
CONFIGS = {"rwkv": "rwkv6-3b", "jamba": "jamba-v0.1-52b"}
PLANS = ("f32", "mpai")
WORLDS = {2: (1, 2), 4: (2, 2)}
STEP_CASES = [(key, pname, world) for key in CONFIGS for pname in PLANS
              for world in WORLDS]
F32_TOL = 1e-6          # relative to the largest |value| of the tensor
PARAM_GRAD_TOL = 1e-5
LOGITS_TOL = 1e-5
DECODE_STEPS = 3
# a step against the one-device Trainer's: loss and grad norm relative,
# each gradient leaf's error over its L2 norm, the parameters' largest and
# mean (over the whole tree) absolute error after the step.  f32:
# ``ONE_TOL``'s levels; ``"mpai"``: its bf16 level with the parameter bound
# of one step (an early Adam step moves a weight by up to ``lr`` whatever
# its gradient) and ``chip_smoke.py``'s gradient bound
STEP_TOL = {"f32": (1e-6, 1e-5, 1e-4, 1e-3, 1e-6),
            "mpai": (2 ** -7, 5e-2, 2e-2, 2.2 * TC_KW["learning_rate"],
                     2e-3)}


def _cfg(key):
    return get_config(CONFIGS[key], smoke=True)


def _plan(pname, n):
    if pname == "mpai":
        return qat.train_plan(PartitionPlan.mpai(n))
    return PartitionPlan.uniform(n, PrecisionPolicy.fp32())


def _leaf(out, key, t):
    out[key] = t.detach().float().numpy().copy()


def _halves(t, rank: int, ranks: int, back: bool = False):
    """Mamba's ``in_proj`` (or its gradient) re-laid from its stored
    part to the rank's channels of both halves, or back (the model group
    is the world); ``t`` itself on one device."""
    if ranks == 1:
        return t
    return collectives.model_halves(t, torch.distributed.group.WORLD,
                                    ranks, rank, back)


def _local(whole, cfg, rank: int, ranks: int):
    """The rank's part of each head-parallel leaf of ``whole`` on (1,
    ranks), Mamba's ``in_proj`` re-laid as the model computes on it, the
    other leaves whole."""
    if ranks == 1:
        return whole
    specs = shard.param_specs(cfg, whole, MESH)
    hp = shard.head_parallel(cfg, whole, MESH)
    local = tree_map(lambda t, sp, h: shard.shard(
        t, sp, MESH, {"data": 0, "model": rank}) if h else t,
        whole, specs, hp)
    for sub in local["layers"].values():
        if "in_proj" in sub.get("mixer", {}):
            sub["mixer"]["in_proj"] = _halves(sub["mixer"]["in_proj"], rank,
                                              ranks)
    return local


def _whole(key, seed):
    return T.model_init(_cfg(key), torch.Generator().manual_seed(seed),
                        "cpu", RANKS)


def _inputs() -> dict:
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    return {"x": t(2, 8, 64), "x_prev": t(2, 64), "g": t(2, 8, 64),
            "prompt": {k: torch.tensor(rng.randint(0, 512, (2, 6)))
                       for k in CONFIGS},
            "dec": {k: torch.tensor(rng.randint(0, 512, (2, DECODE_STEPS)))
                    for k in CONFIGS}}


# ---------------------------------------------------------------------------
# the mixers (layer 0's of each smoke config)
# ---------------------------------------------------------------------------
def _grads(out, key, params, names, rank, ranks):
    """The gradients of ``names``; Mamba's ``in_proj`` laid back as it is
    stored."""
    for name in names:
        g = params[name].grad
        if name == "in_proj":
            g = _halves(g, rank, ranks, back=True)
        _leaf(out, f"{key}/d{name}", g)


def _mixers(out, inp, rank, ranks):
    f32, int8 = PrecisionPolicy.fp32(), PrecisionPolicy.int8()
    x0 = inp["x"]
    for pname, pol in (("f32", f32), ("quant", int8)):
        grad = pname == "f32"
        # Mamba: jamba-smoke's sub-layer 1
        cfg = _cfg("jamba")
        mixer = tree_map(lambda a: a[0].clone().requires_grad_(grad), _local(
            _whole("jamba", 1), cfg, rank, ranks)["layers"]["sub_1"]["mixer"])
        x = x0.clone().requires_grad_(grad)
        y, cache = mam.mamba_apply(mixer, cfg, x, pol, return_state=True)
        _leaf(out, f"mamba/{pname}/out", y)
        _leaf(out, f"mamba/{pname}/h", cache.h)
        if grad:
            (y * inp["g"]).sum().backward()
            _leaf(out, "mamba/f32/dx", x.grad)
            _grads(out, "mamba/f32", mixer, (
                "in_proj", "x_proj", "dt_proj", "conv_w", "conv_b",
                "dt_bias", "A_log", "D", "out_proj"), rank, ranks)
        # RWKV-6: rwkv6-smoke's layer 0, time mix then channel mix
        cfg = _cfg("rwkv")
        sub = tree_map(lambda a: a[0].clone().requires_grad_(grad), _local(
            _whole("rwkv", 2), cfg, rank, ranks)["layers"]["sub_0"])
        x = x0.clone().requires_grad_(grad)
        y, s_fin, _ = rwk.time_mix_apply(sub["mixer"], cfg, x, inp["x_prev"],
                                         RANKS, pol)
        _leaf(out, f"time_mix/{pname}/out", y)
        _leaf(out, f"time_mix/{pname}/state", s_fin)
        if grad:
            (y * inp["g"]).sum().backward()
            _leaf(out, "time_mix/f32/dx", x.grad)
            _grads(out, "time_mix/f32", sub["mixer"], (
                "w_r", "w_k", "w_v", "w_g", "w_o", "w0", "wB", "u",
                "gn_scale", "gn_bias", "wA", "mix_A", "mix_B", "mu"),
                   rank, ranks)
        x = x0.clone().requires_grad_(grad)
        y, _ = rwk.channel_mix_apply(sub["mlp"], x, inp["x_prev"], pol)
        _leaf(out, f"channel_mix/{pname}/out", y)
        if grad:
            (y * inp["g"]).sum().backward()
            _leaf(out, "channel_mix/f32/dx", x.grad)
            _grads(out, "channel_mix/f32", sub["mlp"],
                   ("w_kc", "w_vc", "w_rc", "mu_k", "mu_r"), rank, ranks)


# ---------------------------------------------------------------------------
# the stacks: prefill into a cache, then decode
# ---------------------------------------------------------------------------
def _model(out, inp, rank, ranks):
    plans = {"f32": lambda n: PartitionPlan.uniform(n,
                                                    PrecisionPolicy.fp32()),
             "mpai": lambda n: qat.serve_plan(PartitionPlan.mpai(n))}
    spies = ("_sublayer_apply", "_rwkv_sublayer_apply")
    real = {name: getattr(T, name) for name in spies}
    for key in CONFIGS:
        cfg = _cfg(key)
        params = _local(_whole(key, 3), cfg, rank, ranks)
        for pname, plan_of in plans.items():
            plan, stream = plan_of(cfg.num_layers), []

            def spy(*args, _real=None, **kw):
                res = _real(*args, **kw)
                stream.append(res[0].detach().float().clone())
                return res
            for name in spies:
                setattr(T, name, lambda *a, _r=real[name], **kw:
                        spy(*a, _real=_r, **kw))
            try:
                with torch.no_grad():
                    cache = T.init_cache(cfg, 2, 16, RANKS, device="cpu")
                    logits = [T.forward(params, cfg, inp["prompt"][key],
                                        plan, RANKS, cache=cache).logits]
                    for i in range(DECODE_STEPS):
                        logits.append(T.decode_step(
                            params, cfg, inp["dec"][key][:, i:i + 1], cache,
                            plan, RANKS).logits)
            finally:
                for name in spies:
                    setattr(T, name, real[name])
            at = f"model/{key}/{pname}"
            for i, lg in enumerate(logits):
                _leaf(out, f"{at}/logits/{i}", lg)
            for i, x in enumerate(stream):
                _leaf(out, f"{at}/stream/{i}", x)
            state = cache["sub_0" if key == "rwkv" else "sub_1"][0]
            out[f"{at}/cache_shape"] = np.array(
                state.s.shape if key == "rwkv" else
                list(state.h.shape) + list(state.conv.shape))


def _windowed(out, rank, ranks):
    """The windowed server, stepped inside the model group: 1 if it
    raises."""
    from repro_torch.runtime.serve import Request, WindowedBaselineServer
    cfg = _cfg("rwkv")
    server = WindowedBaselineServer(_local(_whole("rwkv", 3), cfg, rank,
                                           ranks), cfg, tp=RANKS,
                                    max_batch=2, prompt_len=4, max_len=8,
                                    device="cpu")
    server.submit(Request(0, np.arange(4, dtype=np.int32), max_new=2))
    try:
        server.step()
        out["windowed/raised"] = np.array(0)
    except ValueError:
        out["windowed/raised"] = np.array(1)


def _relay(out, rank, ranks, d):
    """``model_halves`` on a whole [3, 2 x 8] tensor's stored part, and
    back; then a (1, 2) ``Trainer``'s state saved and, on rank 0, restored
    on one device."""
    from repro_torch.checkpoint.manager import CheckpointManager
    whole = torch.arange(48, dtype=torch.float32).reshape(3, 16)
    stored = whole[:, rank * 8:(rank + 1) * 8]
    laid = _halves(stored, rank, ranks)
    want = torch.cat([whole[:, rank * 4:(rank + 1) * 4],
                      whole[:, 8 + rank * 4:8 + (rank + 1) * 4]], dim=-1)
    out["relay/laid"] = np.array(torch.equal(laid, want))
    out["relay/back"] = np.array(torch.equal(
        _halves(laid, rank, ranks, back=True), stored))
    cfg = _cfg("jamba")
    shape = ShapeConfig("t", S, B, "train")
    tr = ttrain.Trainer(cfg, shape, MESH, TrainConfig(**TC_KW), device="cpu")
    ck = CheckpointManager(os.path.join(d, "ckpt"), keep=1)
    ck.save(0, tr.init_state(), blocking=True,
            shardings=tr.state_shardings)
    torch.distributed.barrier()
    if rank == 0:
        one = ttrain.Trainer(cfg, shape, MeshConfig((1, 1), MESH.axes),
                             TrainConfig(**TC_KW), device="cpu")
        st, _ = ck.restore(one.state_like(), device="cpu")
        out["relay/restored_equal"] = np.array(all(
            torch.equal(a, b) for a, b in zip(
                tree_leaves(st.params), tree_leaves(one.init_state().params))))
    torch.distributed.barrier()


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def _weights(d, key):
    path = os.path.join(d, f"weights_{key}.npz")
    _wait_for(path)
    return bridge.to_torch(_unflatten(dict(np.load(path)), "w"), "cpu")


def _step(out, d, key, pname, mesh, count=False):
    """One step of ``key`` under ``pname`` on ``mesh`` from the reference's
    weights: loss, grad norm and the gathered parameters; with ``count``
    the step's collectives."""
    from repro_torch.launch import dryrun as D
    cfg = _cfg(key)
    tr = ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                        MeshConfig(mesh, ("data", "model")),
                        TrainConfig(**TC_KW),
                        plan=_plan(pname, cfg.num_layers), device="cpu")
    params = _weights(d, key)
    state = ttrain.TrainState(params, adamw.init(params),
                              torch.zeros((), dtype=torch.int32))
    if tr.state_shardings is not None:
        state = tr.state_shardings.shard(state)
    tally, seen = D.Tally(), []
    real = adamw.apply_updates

    def spy(params, grads, *a, **kw):
        seen.append(tree_map(torch.clone, grads))
        return real(params, grads, *a, **kw)
    adamw.apply_updates = spy
    try:
        with D.counted_collectives(tally):
            state, m = tr.step_fn(state, lm_batch(cfg, ShapeConfig(
                "t", S, B, "train"), 0, device="cpu"))
    finally:
        adamw.apply_updates = real
    at = f"step/{key}/{pname}/{'x'.join(map(str, mesh))}"
    out[f"{at}/loss"] = np.array(float(m["loss"]))
    out[f"{at}/grad_norm"] = np.array(float(m["grad_norm"]))
    whole = lambda t: (t if tr.state_shardings is None
                       else tr.param_shardings.unshard(t))
    _flatten(whole(state.params), f"{at}/params", out)
    # the gradient AdamW got (the rank's slices), put together
    _flatten(whole(seen[0]), f"{at}/grad", out)
    if count and tr.state_shardings is not None:
        model = tuple(torch.distributed.get_process_group_ranks(
            tr.placement.group((shard.MODEL,))))
        hp_shapes = {tuple(t.shape) for t, h in zip(
            tree_leaves(state.params), tree_leaves(tr.head_parallel)) if h}
        calls = tally.coll_calls
        out[f"{at}/model_gathers"] = np.array(sum(
            kind == "all-gather" and ranks == model
            for kind, _, ranks in calls))
        out[f"{at}/leaf_gathers"] = np.array(sum(
            kind == "all-gather" and tuple(shp) in hp_shapes
            for kind, shp, _ in calls))
        out[f"{at}/all_to_alls"] = np.array(sum(
            kind == "all-to-all" and ranks == model
            for kind, _, ranks in calls))
        out[f"{at}/all_reduces"] = np.array(sum(
            kind == "all-reduce" and ranks == model
            for kind, _, ranks in calls))


def _compute(rank: int, ranks: int, d: str) -> dict:
    """The (1, 2) checks' values on rank ``rank`` of ``ranks`` (inside the
    model group when ``ranks > 1``; one device otherwise)."""
    inp, out = _inputs(), {}
    group = torch.distributed.group.WORLD if ranks > 1 else None
    with collectives.model_group(group, ranks, rank):
        _mixers(out, inp, rank, ranks)
        _model(out, inp, rank, ranks)
        if ranks > 1:
            _windowed(out, rank, ranks)
            _relay(out, rank, ranks, d)
    return out


def _rank(rank: int, world: int, d: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, f"store{world}"), world),
        rank=rank, world_size=world)
    try:
        out = _compute(rank, world, d) if world == RANKS else {}
        for key in CONFIGS:
            for pname in PLANS:
                _step(out, d, key, pname, WORLDS[world],
                      count=world == RANKS)
        np.savez(os.path.join(d, f"w{world}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _reference(key: str, d: str) -> None:
    """The reference's weights of ``key`` (written first: the ranks wait
    for them) and one jitted step of each plan from them."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jconfig
    from repro.configs.base import ShapeConfig as JShape
    from repro.configs.base import TrainConfig as JTrain
    from repro.core import qat as jqat
    from repro.core.partition import PartitionPlan as JPlan
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.data.pipeline import lm_batch as jbatch
    from repro.models import transformer as JT
    from repro.optim import adamw as jadamw
    from repro.runtime.train_loop import TrainState, make_step_fn

    cfg = jconfig(CONFIGS[key], smoke=True)
    params = jax.jit(lambda k: JT.model_init(k, cfg))(jax.random.PRNGKey(0))
    w = {}
    _flatten(params, "w", w)
    tmp = os.path.join(d, f"weights_{key}.tmp.npz")
    np.savez(tmp, **w)
    os.rename(tmp, os.path.join(d, f"weights_{key}.npz"))
    res = {}
    for pname in PLANS:
        plan = (jqat.train_plan(JPlan.mpai(cfg.num_layers)) if pname == "mpai"
                else JPlan.uniform(cfg.num_layers, JPolicy.fp32()))
        step = jax.jit(make_step_fn(cfg, JTrain(**TC_KW), plan, 1))
        state = TrainState(params, jadamw.init(params, jnp.float32),
                           jnp.zeros((), jnp.int32))
        _, m = step(state, jbatch(cfg, JShape("t", S, B, "train"), 0))
        res[f"{pname}/loss"] = np.asarray(m["loss"])
        res[f"{pname}/grad_norm"] = np.asarray(m["grad_norm"])
    np.savez(os.path.join(d, f"ref_{key}.npz"), **res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(one device, {world: [rank results]}, {config: reference})``: the
    references, both worlds' ranks and the one-device side at once."""
    d = tmp_path_factory.mktemp("recurrent_head_parallel")
    procs = [subprocess.Popen([sys.executable, __file__, "ref", key, str(d)],
                              env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for key in CONFIGS]
    procs += [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world), str(d)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for world in WORLDS for r in range(world)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _compute(0, 1, str(d))
        for key in CONFIGS:
            for pname in PLANS:
                _step(one, str(d), key, pname, (1, 1))
    finally:
        torch.set_num_threads(threads)
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    worlds = {w: [dict(np.load(d / f"w{w}_rank{r}.npz")) for r in range(w)]
              for w in WORLDS}
    ref = {key: dict(np.load(d / f"ref_{key}.npz")) for key in CONFIGS}
    return one, worlds, ref


def _cat(ranks, key, dim):
    return np.concatenate([r[key] for r in ranks], axis=dim)


def _close(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# (1, 2) against one device
# ---------------------------------------------------------------------------
# each mixer's parameters by how a rank holds them: the dim its part is cut
# along (None: replicated, every rank's gradient the whole one's)
MIXER_GRADS = {
    "mamba": {"in_proj": 1, "x_proj": 0, "dt_proj": 1, "conv_w": 1,
              "conv_b": 0, "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0},
    "time_mix": {"w_r": 1, "w_k": 1, "w_v": 1, "w_g": 1, "w_o": 0, "w0": 0,
                 "wB": 1, "u": 0, "gn_scale": 0, "gn_bias": 0, "wA": None,
                 "mix_A": None, "mix_B": None, "mu": None},
    "channel_mix": {"w_kc": 1, "w_vc": 0, "w_rc": 1, "mu_k": None,
                    "mu_r": None},
}


@pytest.mark.parametrize("mixer", list(MIXER_GRADS))
def test_mixer_on_1x2_equals_one_device(runs, mixer):
    """f32: the output and the input gradient on every rank within
    ``F32_TOL``, each parameter's gradient (the ranks' parts put together,
    a replicated leaf's on every rank) within ``PARAM_GRAD_TOL``."""
    one, worlds, _ = runs
    ranks = worlds[2]
    for got in ranks:
        for key in ("out", "dx"):
            _close(got[f"{mixer}/f32/{key}"], one[f"{mixer}/f32/{key}"],
                   F32_TOL, key)
    for name, dim in MIXER_GRADS[mixer].items():
        key = f"{mixer}/f32/d{name}"
        if dim is None:
            for got in ranks:
                _close(got[key], one[key], PARAM_GRAD_TOL, name)
        else:
            _close(_cat(ranks, key, dim), one[key], PARAM_GRAD_TOL, name)


def test_recurrent_states_are_the_ranks_heads_and_channels(runs):
    """The final wkv state of the time mix holds the rank's heads, the
    Mamba state its channels: put together, one device's."""
    one, worlds, _ = runs
    ranks = worlds[2]
    _close(_cat(ranks, "time_mix/f32/state", 1), one["time_mix/f32/state"],
           F32_TOL, "wkv state")
    _close(_cat(ranks, "mamba/f32/h", 1), one["mamba/f32/h"], F32_TOL,
           "scan state")


@pytest.mark.parametrize("mixer", list(MIXER_GRADS))
def test_int8_mixers_split_are_bit_equal(runs, mixer):
    """Under the ``"quant"`` plan every product is an int8 GEMM: the
    column-parallel ones give the product's columns, the row-parallel ones
    all-reduce their int32 accumulators, so the split mixer's output is
    one device's bit for bit."""
    one, worlds, _ = runs
    for got in worlds[2]:
        np.testing.assert_array_equal(got[f"{mixer}/quant/out"],
                                      one[f"{mixer}/quant/out"])


@pytest.mark.parametrize("key", list(CONFIGS))
def test_forward_and_decode_logits_on_1x2(runs, key):
    one, worlds, _ = runs
    for i in range(DECODE_STEPS + 1):
        at = f"model/{key}/f32/logits/{i}"
        _close(_cat(worlds[2], at, 2), one[at], LOGITS_TOL, at)
        got = _cat(worlds[2], f"model/{key}/mpai/logits/{i}", 2)
        assert np.isfinite(got).all()


@pytest.mark.parametrize("key", list(CONFIGS))
def test_int8_layers_of_the_mpai_serving_plan_are_bit_equal(runs, key):
    """Every layer but the last runs int8 under the served ``"mpai"``
    plan: its output, at prefill and each decode step, equals one
    device's bit for bit."""
    one, worlds, _ = runs
    layers = _cfg(key).num_layers
    keys = [k for k in one if k.startswith(f"model/{key}/mpai/stream/")]
    assert len(keys) == layers * (DECODE_STEPS + 1)
    int8 = [k for k in keys if int(k.rsplit("/", 1)[1]) % layers < layers - 1]
    for got in worlds[2]:
        for k in int8:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)


@pytest.mark.parametrize("pname", ["f32", "mpai"])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_residual_stream_is_identical_on_both_model_ranks(runs, key, pname):
    _, worlds, _ = runs
    ranks = worlds[2]
    keys = [k for k in ranks[0] if k.startswith(f"model/{key}/{pname}/"
                                                f"stream/")]
    cfg = _cfg(key)
    assert len(keys) == cfg.num_layers * (DECODE_STEPS + 1)
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_decode_caches_hold_the_ranks_heads_and_channels(runs):
    """A rank's RWKV-6 state is ``[B, Hp / tp, N, N]``, its Mamba state
    ``[B, d_inner / tp, N]`` and conv tail ``[B, k - 1, d_inner / tp]``."""
    one, worlds, _ = runs
    hp, n, _ = rwk.rwkv_dims(_cfg("rwkv"), RANKS)
    mc = _cfg("jamba").mamba
    di = mc.expand * _cfg("jamba").d_model
    for got in worlds[2]:
        np.testing.assert_array_equal(got["model/rwkv/f32/cache_shape"],
                                      [2, hp // RANKS, n, n])
        np.testing.assert_array_equal(
            got["model/jamba/f32/cache_shape"],
            [2, di // RANKS, mc.d_state, 2, mc.d_conv - 1, di // RANKS])
    np.testing.assert_array_equal(one["model/rwkv/f32/cache_shape"],
                                  [2, hp, n, n])


def test_windowed_server_refuses_a_model_group(runs):
    for got in runs[1][2]:
        assert int(got["windowed/raised"]) == 1


def test_in_proj_relay_round_trips_and_checkpoints_keep_its_order(runs):
    """``model_halves`` gives the rank's channels of both halves and lays
    them back; a (1, 2) state saved and restored on one device equals the
    one-device init bit for bit (the stored layout is the reference's)."""
    ranks = runs[1][2]
    for got in ranks:
        assert bool(got["relay/laid"]) and bool(got["relay/back"])
    assert bool(ranks[0]["relay/restored_equal"])


def _all_to_all(bufs, splits):
    """What ``all_to_all_single`` hands each of ``len(bufs)`` ranks: from
    every rank in rank order, the run of its buffer's dim 0 that its input
    split sizes (``splits[src]``) address to that rank."""
    n = len(bufs)
    starts = [np.cumsum([0] + s) for s in splits]
    return [torch.cat([bufs[src][starts[src][dst]:starts[src][dst + 1]]
                       for src in range(n)]) for dst in range(n)]


@pytest.mark.parametrize("n", [2, 3, 4, 16])
def test_in_proj_relay_route_at_n_ranks(n):
    """``model_halves``' packing and unpacking with the all-to-all between
    them played out in one process: on ``n`` ranks of a whole dim of
    ``2n`` labelled pieces (rank ``j`` stores pieces ``2j, 2j + 1``) each
    rank gets pieces ``j, n + j``, and ``back`` restores every rank's
    stored part."""
    width = 3
    whole = torch.arange(5 * 2 * n * width).reshape(5, 2 * n * width)

    def piece(c):
        return whole[:, c * width:(c + 1) * width]

    def relay(parts, back):
        packed = [collectives._halves_pack(t, n, j, back)
                  for j, t in enumerate(parts)]
        got = _all_to_all([b for b, _, _ in packed],
                          [ins for _, _, ins in packed])
        for j, (b, outs, _) in enumerate(packed):
            assert got[j].shape == b.shape and sum(outs) == 2
        return [collectives._halves_unpack(g, n, j, back, t.shape)
                for j, (g, t) in enumerate(zip(got, parts))]
    stored = [whole[:, 2 * j * width:(2 * j + 2) * width] for j in range(n)]
    laid = relay(stored, back=False)
    for j in range(n):
        assert torch.equal(laid[j], torch.cat([piece(j), piece(n + j)], -1))
    for j, t in enumerate(relay(laid, back=True)):
        assert torch.equal(t, stored[j])


# ---------------------------------------------------------------------------
# steps on (1, 2) and (2, 2)
# ---------------------------------------------------------------------------
def _step_key(key, pname, mesh):
    return f"step/{key}/{pname}/{'x'.join(map(str, mesh))}"


@pytest.mark.parametrize("key,pname,world", STEP_CASES,
                         ids=[f"{k}-{p}-{'x'.join(map(str, WORLDS[w]))}"
                              for k, p, w in STEP_CASES])
def test_step_equals_the_reference(runs, key, pname, world):
    _, worlds, ref = runs
    got = worlds[world][0]
    at = _step_key(key, pname, WORLDS[world])
    l_tol, n_tol = REF_TOL[pname][:2]
    want_l = float(ref[key][f"{pname}/loss"])
    want_n = float(ref[key][f"{pname}/grad_norm"])
    assert abs(float(got[f"{at}/loss"]) - want_l) <= l_tol * want_l
    assert abs(float(got[f"{at}/grad_norm"]) - want_n) <= n_tol * want_n


@pytest.mark.parametrize("key,pname,world", STEP_CASES,
                         ids=[f"{k}-{p}-{'x'.join(map(str, WORLDS[w]))}"
                              for k, p, w in STEP_CASES])
def test_step_equals_the_one_device_trainer(runs, key, pname, world):
    """Within ``STEP_TOL``.  The gradient is held leaf by leaf, the
    parameters after the step by their mean over the whole tree: AdamW
    divides each gradient entry by its own magnitude, so an entry whose
    terms cancel to ~1e-8 moves by a visible part of ``lr`` when they are
    summed in another order (``jamba-smoke``'s ``sub_5`` ``norm2`` scale,
    entry 59: 2.82e-8 on (1, 2) against 3.07e-8 on one device, moved
    1.0e-4 apart, 1.6e-6 on average over its 64 entries; measured)."""
    one, worlds, _ = runs
    at = _step_key(key, pname, WORLDS[world])
    want = _step_key(key, pname, (1, 1))
    l_tol, n_tol, g_tol, max_tol, mean_tol = STEP_TOL[pname]
    wl, wn = float(one[f"{want}/loss"]), float(one[f"{want}/grad_norm"])
    for got in worlds[world]:
        np.testing.assert_array_equal(got[f"{at}/loss"],
                                      worlds[world][0][f"{at}/loss"])
        assert abs(float(got[f"{at}/loss"]) - wl) <= l_tol * wl
        assert abs(float(got[f"{at}/grad_norm"]) - wn) <= n_tol * wn
        grads, want_g = _params(got, f"{at}/grad"), _params(one,
                                                             f"{want}/grad")
        assert sorted(grads) == sorted(want_g)
        errs = {k: float(np.linalg.norm(grads[k] - want_g[k])
                         / max(np.linalg.norm(want_g[k]), 1e-30))
                for k in want_g}
        assert max(errs.values()) <= g_tol, max(errs.items(),
                                                 key=lambda kv: kv[1])
        have, want_p = _params(got, f"{at}/params"), _params(
            one, f"{want}/params")
        diffs = [np.abs(have[k] - want_p[k]) for k in want_p]
        assert max(float(x.max()) for x in diffs) <= max_tol
        mean = sum(float(x.sum()) for x in diffs) / sum(x.size for x in diffs)
        assert mean <= mean_tol, mean


@pytest.mark.parametrize("key", list(CONFIGS))
def test_a_step_gathers_no_model_axis_part_of_a_recurrent_leaf(runs, key):
    """On (1, 2) no leaf is split over data: no all-gather of any
    head-parallel leaf's part.  Over the model group: RWKV-6 all-gathers
    its receptance once a layer, Jamba its experts' outputs once an MoE
    layer (``tests/test_torch_head_parallel.py``); Jamba re-lays each
    stacked ``in_proj`` by an all-to-all and its gradient by another; the
    TP all-reduces run."""
    cfg = _cfg(key)
    gathers = (cfg.num_layers if key == "rwkv"
               else sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers)))
    # one stacked in_proj a Mamba sub-layer of the pattern
    mamba = sum(kind == "mamba" for kind, _ in T.sublayer_pattern(cfg))
    for got in runs[1][2]:
        for pname in PLANS:
            at = _step_key(key, pname, WORLDS[2])
            assert int(got[f"{at}/leaf_gathers"]) == 0
            assert int(got[f"{at}/model_gathers"]) == gathers
            assert int(got[f"{at}/all_to_alls"]) == 2 * mamba
            assert int(got[f"{at}/all_reduces"]) > 0


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        _reference(sys.argv[2], sys.argv[3])
    else:
        _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
