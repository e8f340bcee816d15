"""Per-layer gathers of the data-axis parts (``sharding.BlockGather``,
``core/collectives.layer_gather``): the mesh ``Trainer`` under FSDP
against the whole-stack step it replaced and the one-device ``Trainer``.

Three worlds (2, 4 and 4 gloo ranks, subprocesses joined through a
``FileStore`` under ``tmp_path``, torch at one thread a rank) run every
case at once; the one-device side runs in the test process.  The cases are
``tiny_dense`` with ``fsdp=True`` at 4 super-blocks, ``remat=True`` and
``remat_group=2``, on (2, 1) and (2, 2), and on (4, 1) with
``grad_accum=2``, each under f32 and bf16; ``jamba-smoke`` with
``fsdp=True`` at two super-blocks on (2, 2) (Mamba's ``in_proj`` re-laid
to the rank's channels, its blocks then gathered over the data axis; MoE
experts on the model axis); and ``tiny_dense`` with ``fsdp=False`` on
(2, 1), whose layers no data axis splits.  Each case, from the port's
seeded init on every rank:

* the step's collectives (``launch.dryrun.counted_collectives``): no
  all-gather of a stacked ``layers`` leaf; every data-axis all-gather's
  operand is one super-block's part of a split leaf, each block gathered
  once in the forward and again in remat's recompute (its own, and with
  ``remat_group`` its group's, which stops before the group's last
  block: ``_passes``);
* the loss of one step equals the whole-stack step's bit for bit (the
  step as ``Trainer._sharded_step`` ran before the layer gather:
  ``TreeSharding.unshard`` of every leaf, ``make_grad_fn``, the gradients
  all-reduced, then cut), since the gathered values are the same bits;
* each gradient slice as AdamW gets it: bit-equal to the whole-stack
  step's with one microbatch on two batch ranks (each element is the same
  two terms summed), else within ``LEAF_TOL`` of the leaf's norm (the
  sums over ranks and microbatches come in another order);
* three steps against the one-device ``Trainer`` within
  ``tests/test_torch_sharded_train.py``'s ``ONE_TOL``;
* ``fsdp=False`` runs no layer gather and makes exactly the whole-stack
  step's collectives.
"""
import collections
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import collectives
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.pipeline import lm_batch
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as ttrain

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 16
STEPS = 3
TC_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50, seed=0)
AXES = ("data", "model")
# (name, config key, mesh, plan, grad_accum)
CASES = [(f"{m}-{p}", "tiny", mesh, p, ga)
         for m, mesh, ga in (("2x1", (2, 1), 1), ("2x2", (2, 2), 1),
                             ("4x1-ga2", (4, 1), 2))
         for p in ("f32", "bf16")] + [
    ("jamba-2x2", "jamba", (2, 2), "f32", 1),
    ("nofsdp-2x1", "nofsdp", (2, 1), "f32", 1)]
# the worlds, each ``(ranks, cases)``, run at once: a gloo collective
# waits milliseconds here, two worlds of 4 take no longer than one
WORLDS = {"w2": (2, [c[0] for c in CASES if c[2] == (2, 1)]),
          "w4": (4, [c[0] for c in CASES if c[2] == (2, 2)]),
          "w4ga": (4, [c[0] for c in CASES if c[2] == (4, 1)])}
# a gradient slice against the whole-stack step's, where the sums over
# ranks and microbatches change order: f32 rounding of those sums (the
# plans differ in the forward, which is the same bits either way)
LEAF_TOL = 1e-5
BF16_TOL = (2 ** -7, 5e-2, 2.2 * TC_KW["learning_rate"] * STEPS, 2e-3, None)
# tests/test_torch_sharded_train.py's bounds against the one-device step
ONE_TOL = {"f32": (1e-6, 1e-5, 1e-3, 1e-6, 1e-4), "bf16": BF16_TOL}
# jamba-smoke's step on (2, 2) against one device (what the whole-stack
# step gives too: its gradient slices are the same bits): ONE_TOL's f32
# levels, the parameters' mean over the whole tree and their largest
# within one Adam step's reach, since AdamW divides each gradient entry by
# its own size and an entry whose terms cancel moves by a visible part of
# ``lr`` when they are summed in another order (1.3e-3, measured;
# tests/test_torch_recurrent_head_parallel.py's STEP_TOL notes the same)
JAMBA_TOL = (1e-6, 1e-5, 2.2 * TC_KW["learning_rate"], 1e-6, None)


def _cfg(key: str, ga: int = 1) -> ModelConfig:
    if key == "jamba":
        return get_config("jamba-v0.1-52b", smoke=True).with_(
            num_layers=16, fsdp=True, remat=True, grad_accum=ga)
    return ModelConfig(name="tiny", family="dense", num_layers=4, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       remat=True, remat_group=2, fsdp=key != "nofsdp",
                       grad_accum=ga)


def _plan(pname: str, n: int):
    return PartitionPlan.uniform(n, PrecisionPolicy.fp32()) \
        if pname == "f32" else None


def _case(name: str):
    return next(c for c in CASES if c[0] == name)


def _steps(name: str) -> int:
    """Steps held to the one-device ``Trainer``: ``jamba-smoke``'s one
    (its gloo collectives, ~40 a block and pass, set the file's time)."""
    return 1 if _case(name)[1] == "jamba" else STEPS


def _trainer(name: str, mesh=None):
    _, key, ms, pname, ga = _case(name)
    cfg = _cfg(key, ga)
    return ttrain.Trainer(cfg, ShapeConfig("t", S, B, "train"),
                          MeshConfig(mesh or ms, AXES), TrainConfig(**TC_KW),
                          plan=_plan(pname, cfg.num_layers), device="cpu")


def _data(cfg):
    shape = ShapeConfig("t", S, B, "train")
    return lambda s: lm_batch(cfg, shape, s, device="cpu")


# ---------------------------------------------------------------------------
# one rank, run as ``python tests/test_torch_layer_gather.py RANK KEY DIR``
# ---------------------------------------------------------------------------
def _whole_stack_step(tr, state, batch):
    """The mesh step with every leaf gathered whole before the forward:
    ``Trainer._sharded_step`` as it ran before the layer gather."""
    import torch.distributed as dist
    from repro_torch import sharding as shard
    pl, hp = tr.placement, tr.head_parallel
    ga = tr.cfg.grad_accum
    rows = {k: v.unflatten(0, (ga, -1))[:, tr.rows].flatten(0, 1)
            for k, v in batch.items()}
    full = tr.param_shardings.unshard(state.params, keep_model=hp)
    group = pl.group(tr.batch_axes) if tr.batch_ranks > 1 else None
    mranks = 1 if hp is None else pl.group_size((shard.MODEL,))
    mgroup = pl.group((shard.MODEL,)) if mranks > 1 else None
    with collectives.batch_group(group, tr.batch_ranks), \
            collectives.model_group(mgroup, mranks,
                                    pl.coord.get(shard.MODEL, 0)):
        l, grads = tr._grads_of(full, rows)
    del full
    if group is not None:

        def mean(t):
            dist.all_reduce(t, group=group)
            return t.div_(tr.batch_ranks)
        l = mean(l.clone())
        grads = tree_map(mean, grads)
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if mgroup is not None:
        split = [i for i, (h, sp, g) in enumerate(zip(
            tree_leaves(hp), tree_leaves(tr.param_specs),
            tree_leaves(grads))) if h and any(
                shard.MODEL in ax for ax in shard.dim_axes(sp, g.ndim))]
        parts = torch.stack([sq[i] for i in split])
        dist.all_reduce(parts, group=mgroup)
        for j, i in enumerate(split):
            sq[i] = parts[j]
    grads = tr.param_shardings.shard(grads, keep_model=hp)
    new, opt, gnorm = adamw.apply_updates(
        state.params, grads, state.opt, tr.tc, donate=True,
        gnorm=torch.sqrt(sum(sq)))
    return (ttrain.TrainState(new, opt, state.step + 1),
            {"loss": l, "grad_norm": gnorm})


def _kept(seen: list):
    """``adamw.apply_updates`` wrapped: each call's gradient leaves (the
    rank's slices, as AdamW gets them) appended to ``seen``."""
    real = adamw.apply_updates

    def spy(params, grads, *a, **kw):
        seen.append([g.clone() for g in tree_leaves(grads)])
        return real(params, grads, *a, **kw)
    return spy


def _step(fn, state, batch, seen):
    from repro_torch.launch import dryrun as D
    tally = D.Tally()
    real, adamw.apply_updates = adamw.apply_updates, _kept(seen)
    try:
        with D.counted_collectives(tally):
            out = fn(state, batch)
    finally:
        adamw.apply_updates = real
    return out, tally.coll_calls


def _run_case(name: str, res: dict) -> None:
    tr = _trainer(name)
    one = _trainer(name, (1, 1))              # one device: not on the mesh
    start = tr.state_shardings.shard(one.init_state())
    data = _data(tr.cfg)
    copy = lambda st: tree_map(torch.clone, st)          # noqa: E731
    whole_seen, seen = [], []
    (_, m_whole), whole_calls = _step(
        lambda st, b: _whole_stack_step(tr, st, b), copy(start), data(0),
        whole_seen)
    (state, m), calls = _step(tr.step_fn, copy(start), data(0), seen)
    hist = [(float(m["loss"]), float(m["grad_norm"]))]
    for s in range(1, _steps(name)):
        state, m = tr.step_fn(state, data(s))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    model = (tuple(torch.distributed.get_process_group_ranks(
        tr.placement.group(("model",)))) if tr.mesh_cfg.shape[1] > 1
        else None)
    res[name] = {
        "blocks": tr.blocks is not None,
        "loss": float(m_whole["loss"]), "first_loss": hist[0][0],
        "grads_equal": [torch.equal(a, b)
                        for a, b in zip(seen[0], whole_seen[0])],
        "grad_errs": [float(torch.linalg.vector_norm(a - b)
                            / max(float(torch.linalg.vector_norm(b)), 1e-30))
                      for a, b in zip(seen[0], whole_seen[0])],
        "history": hist,
        "params": [t.clone() for t in tree_leaves(
            tr.param_shardings.unshard(state.params))],
        "calls": calls, "whole_calls": whole_calls, "model_group": model,
        "stacked": [tuple(t.shape) for t, blk in zip(
            tree_leaves(start.params),
            tree_leaves(tr.blocks.leaves)) if blk] if tr.blocks else [],
    }


def _rank(rank: int, key: str, d: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    world, names = WORLDS[key]
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, f"store_{key}"),
                                     world),
        rank=rank, world_size=world)
    try:
        res = {}
        for name in names:
            _run_case(name, res)
        torch.save(res, os.path.join(d, f"{key}_rank{rank}.pt"))
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
    """``{world: [rank results]}``: every world's ranks at once."""
    d = tmp_path_factory.mktemp("layer_gather")
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), key,
                               str(d)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for key, (world, _) in WORLDS.items() for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    return {key: [torch.load(d / f"{key}_rank{r}.pt", weights_only=False)
                  for r in range(world)]
            for key, (world, _) in WORLDS.items()}


def _ranks(runs, name):
    key = next(k for k, (_, names) in WORLDS.items() if name in names)
    return [r[name] for r in runs[key]]


def _data_gathers(r) -> list:
    """The step's all-gathers that are not over the model group: the
    layer gather's (with their operand shapes)."""
    return [tuple(shp) for kind, shp, ranks in r["calls"]
            if kind == "all-gather" and ranks != r["model_group"]]


def _passes(cfg) -> int:
    """How often one microbatch gathers each block under remat: once in
    the forward, once in the block's own recompute, and with
    ``remat_group`` once more in its group's recompute, which stops after
    the group's last block but one has given the tensors it saved."""
    n, g = cfg.num_layers // T.pattern_period(cfg), cfg.remat_group
    if g and n % g == 0:
        return n * 2 + (n - n // g)
    return 2 * n


GATHERED = [c[0] for c in CASES if c[1] != "nofsdp"]


@pytest.mark.parametrize("name", GATHERED)
def test_no_all_gather_of_a_stacked_layers_leaf(runs, name):
    """Every data-axis all-gather's operand is one super-block's part of a
    split leaf, never a stacked leaf; each block of each such leaf is
    gathered in the forward and again in remat's recompute."""
    cfg = _cfg(_case(name)[1], _case(name)[4])
    for r in _ranks(runs, name):
        assert r["blocks"] and r["stacked"]
        # each split leaf's block part, as often as the passes reach it
        # (a stacked leaf's gather would add to these counts: at two
        # blocks of two experts a rank, its shape may be a block's)
        want = collections.Counter()
        for shp in r["stacked"]:
            want[shp[1:]] += cfg.grad_accum * _passes(cfg)
        assert collections.Counter(_data_gathers(r)) == want
        # the whole-stack step gathered each stacked leaf once
        assert sorted(_data_gathers({**r, "calls": r["whole_calls"]})) == \
            sorted(r["stacked"])


@pytest.mark.parametrize("name", GATHERED)
def test_loss_equals_the_whole_stack_steps(runs, name):
    for r in _ranks(runs, name):
        assert r["first_loss"] == r["loss"], (r["first_loss"], r["loss"])


@pytest.mark.parametrize("name", GATHERED)
def test_gradient_slices_against_the_whole_stack_step(runs, name):
    """Bit-equal with one microbatch on two batch ranks; within
    ``LEAF_TOL`` of each leaf's norm where the sums change order."""
    _, _, ms, _, ga = _case(name)
    for r in _ranks(runs, name):
        if ga == 1 and ms[0] == 2:
            assert all(r["grads_equal"]), r["grad_errs"]
        else:
            assert max(r["grad_errs"]) <= LEAF_TOL, r["grad_errs"]


@functools.lru_cache(maxsize=None)
def _one_device(name: str):
    """The one-device ``Trainer``'s history and final parameters for the
    case's config, plan and steps, from the same seeded init."""
    tr = _trainer(name, (1, 1))
    state, hist = tr.run(tr.init_state(), _data(tr.cfg), _steps(name),
                         log_every=1)
    return ([(h["loss"], h["grad_norm"]) for h in hist],
            [t.clone() for t in tree_leaves(state.params)])


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_steps_equal_the_one_device_trainer(runs, name):
    """Every rank's history equal, and within ``ONE_TOL`` of one device's
    (loss and grad norm relative, the parameters' largest and mean
    |diff|, each leaf's error over its norm); ``jamba-smoke``'s one step
    within ``JAMBA_TOL``."""
    l_tol, n_tol, max_tol, mean_tol, leaf_tol = (
        JAMBA_TOL if _case(name)[1] == "jamba" else ONE_TOL[_case(name)[3]])
    hist, params = _one_device(name)
    ranks = _ranks(runs, name)
    for r in ranks:
        assert r["history"] == ranks[0]["history"]
    got = ranks[0]
    assert len(got["history"]) == len(hist)
    for (gl, gn), (wl, wn) in zip(got["history"], hist):
        assert abs(gl - wl) <= l_tol * wl, (gl, wl)
        assert abs(gn - wn) <= n_tol * wn, (gn, wn)
    diffs = [(a.float() - b.float()).abs()
             for a, b in zip(got["params"], params)]
    if leaf_tol is None:        # jamba: the mean over the whole tree
        assert sum(float(d.sum()) for d in diffs) <= \
            mean_tol * sum(d.numel() for d in diffs)
    for a, b, d in zip(got["params"], params, diffs):
        assert d.max() <= max_tol, float(d.max())
        assert leaf_tol is None or d.mean() <= mean_tol, float(d.mean())
        if leaf_tol is not None:
            assert float(torch.linalg.vector_norm(a.float() - b.float())) \
                <= leaf_tol * float(torch.linalg.vector_norm(b.float()))


def test_no_data_axis_split_runs_the_whole_stack_step(runs):
    """``fsdp=False`` on (2, 1): no layer gather, and exactly the
    collectives of the whole-stack step, in order."""
    for r in _ranks(runs, "nofsdp-2x1"):
        assert not r["blocks"]
        assert r["calls"] == r["whole_calls"]
        assert r["first_loss"] == r["loss"] and all(r["grads_equal"])


def test_a_one_rank_mesh_and_one_device_run_no_layer_gather(tmp_path):
    """A world of one rank splits nothing: the ``Trainer`` makes no layer
    gather, and outside the context a block is each leaf's ``a[i]``."""
    import torch.distributed as dist
    layers = {"w": torch.arange(24.0).reshape(4, 2, 3)}
    assert torch.equal(collectives.layer_block(layers, 2)["w"],
                       layers["w"][2])
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        tr = ttrain.Trainer(_cfg("tiny"), ShapeConfig("t", S, B, "train"),
                            MeshConfig((1, 1), AXES),
                            TrainConfig(**TC_KW), device="cpu")
        assert tr.mesh is not None and tr.blocks is None
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2], sys.argv[3])
