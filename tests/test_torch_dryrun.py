"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, and against real steps of the mesh ``Trainer``.

* Per-rank argument bytes equal the reference's compiled
  ``memory_analysis().argument_size_in_bytes`` on a (2, 2) mesh of forced
  host devices, for a smoke config of each family under train, prefill and
  decode, and prefill and decode under ``--plan mpai``; and the sums of
  ``NamedSharding(mesh, spec).shard_shape`` bytes of the reference's
  arguments for all 32 full-width cells on ``SINGLE_POD`` and ``MULTI_POD``
  (no compile).  Those structs take the one-super-block shortcut of
  ``tests/test_torch_sharding.py``, which holds it to the full trace.
* The collective bytes by kind of one traced ``tiny`` step equal those a
  real mesh ``Trainer`` step moves on 2 and 4 gloo ranks, counted by the
  same wrapping of ``torch.distributed``.
* The FLOPs counted outside the kernels equal ``FlopCounterMode``'s count
  of a real CPU step of ``tiny`` on a one-rank gloo mesh, in which a spy
  runs each kernel front door outside the counter; the traced kernel calls
  equal the spy's list.
* ``make_production_mesh`` on fake worlds of 256 and 512 ranks, and the
  CLI's JSON and exit codes.

The reference runs once, in a subprocess with 512 forced host devices
(as its dry run runs), and returns its numbers as JSON.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import (MULTI_POD, SINGLE_POD, MeshConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]
SMOKE_ARCHS = ("qwen3-14b", "stablelm-1.6b", "rwkv6-3b", "jamba-v0.1-52b",
               "olmoe-1b-7b", "llava-next-mistral-7b")
SMOKE_SHAPES = {"train": ("t", 64, 8, "train"),
                "prefill": ("p", 64, 4, "prefill"),
                "decode": ("d", 64, 4, "decode")}
SMOKE_CELLS = [(a, k, "bf16") for a in SMOKE_ARCHS for k in SMOKE_SHAPES] \
    + [(a, k, "mpai") for a in SMOKE_ARCHS for k in ("prefill", "decode")]
MESH_2X2 = MeshConfig((2, 2), ("data", "model"))
MESHES = {"single": SINGLE_POD, "multi": MULTI_POD}
REFERENCE_KEYS = {"arch", "shape", "mesh", "compile_s", "flops", "hlo_bytes",
                  "temp_size_in_bytes", "argument_size_in_bytes",
                  "output_size_in_bytes", "generated_code_size_in_bytes",
                  "collective_bytes", "collective_counts",
                  "collective_bytes_by_kind", "roofline", "scanned_raw",
                  "probe_s"}


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_dryrun.py OUT.json``
# ---------------------------------------------------------------------------
def _reference(out_path):
    # the reference's dry run fakes 512 host devices as it is imported
    from repro.launch import dryrun as JD
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP
    from repro import sharding as jshard
    from repro.configs import cells as jcells, get_config as jget
    from repro.configs.base import (MULTI_POD as JMULTI, SINGLE_POD as JSINGLE,
                                    MeshConfig as JMesh,
                                    ShapeConfig as JShape)
    from repro.configs.base import SHAPES as JSHAPES
    from repro.launch import specs as JS
    from repro.launch.mesh import make_mesh_from_config
    from repro.models import transformer as JT
    from repro.optim import adamw as jadamw
    from repro.runtime.train_loop import TrainState as JState

    @functools.lru_cache(maxsize=None)
    def shortcut(arch, tp):
        cfg = jget(arch)
        period = JT.pattern_period(cfg)
        one = jax.eval_shape(
            functools.partial(JT.model_init,
                              cfg=dataclasses.replace(cfg, num_layers=period),
                              tp=tp), jax.random.PRNGKey(0))
        n = cfg.num_layers // period
        one["layers"] = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct((n,) + s.shape[1:], s.dtype),
            one["layers"])
        return one

    def param_structs(cfg, tp, dtype=None):
        shapes = shortcut(cfg.name, tp)
        if dtype is None:
            return shapes
        return jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(
                s.shape, dtype if jnp.issubdtype(s.dtype, jnp.floating)
                else s.dtype), shapes)

    out = {"compiled": {}, "shard_bytes": {}}
    mesh_cfg = JMesh((2, 2), ("data", "model"))
    mesh = make_mesh_from_config(mesh_cfg)
    for arch, kind, plan in SMOKE_CELLS:
        shape = JShape(*SMOKE_SHAPES[kind])
        lowered = JD.lower_cell(jget(arch, smoke=True), shape, mesh,
                                mesh_cfg, plan)
        out["compiled"][f"{arch}/{kind}/{plan}"] = int(
            lowered.compile().memory_analysis().argument_size_in_bytes)

    def shard_bytes(tree, specs, mesh):
        shardings = jshard.make_shardings(mesh, specs)
        return int(sum(
            int(np.prod(sh.shard_shape(s.shape), dtype=np.int64))
            * jnp.dtype(s.dtype).itemsize
            for s, sh in zip(jax.tree_util.tree_leaves(tree),
                             jax.tree_util.tree_leaves(shardings))))

    JS.param_structs = param_structs        # the shortcut, for these sums
    for mname, mcfg in (("single", JSINGLE), ("multi", JMULTI)):
        mesh = make_mesh_from_config(mcfg)
        for arch, sname, _ in jcells():
            cfg, shape, tp = jget(arch), JSHAPES[sname], mcfg.tp
            batch = JS.batch_specs(cfg, shape)
            data_sp = jshard.data_specs(cfg, shape, mcfg)
            if shape.kind == "train":
                # the state ``lower_cell`` gives the jitted step
                params = JS.param_structs(cfg, tp)
                sp = jshard.param_specs(cfg, params, mcfg)
                scalar = jax.ShapeDtypeStruct((), jnp.int32)
                state = JState(params, jadamw.AdamWState(params, params,
                                                         scalar), scalar)
                total = shard_bytes(state, JState(
                    sp, jadamw.AdamWState(sp, sp, JP()), JP()), mesh)
            else:
                params = JS.param_structs(cfg, tp, jnp.bfloat16)
                sp = jshard.param_specs(cfg, params, mcfg)
                total = shard_bytes(params, sp, mesh)
            if shape.kind == "decode":
                tok, cache = JS.decode_specs(cfg, shape, tp)
                total += shard_bytes(tok["tokens"], data_sp["tokens"], mesh)
                total += shard_bytes(cache, jshard.cache_specs(
                    cfg, cache, shape, mcfg), mesh)
            else:
                total += shard_bytes(batch, data_sp, mesh)
            out["shard_bytes"][f"{mname}/{arch}/{sname}"] = total
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


def _args_bytes(cell) -> int:
    from repro_torch.core.tree import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(cell.arguments(device="meta")))


# ---------------------------------------------------------------------------
# argument bytes
# ---------------------------------------------------------------------------
def test_smoke_argument_bytes_equal_the_compiled_reference(ref):
    got = {}
    with D.fake_world(MESH_2X2.num_devices):
        for arch, kind, plan in SMOKE_CELLS:
            cell = D.Cell(get_config(arch, smoke=True),
                          ShapeConfig(*SMOKE_SHAPES[kind]), MESH_2X2, plan)
            got[f"{arch}/{kind}/{plan}"] = _args_bytes(cell)
    assert got == ref["compiled"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_full_width_argument_bytes_equal_the_shard_shapes(ref, mesh):
    mesh_cfg = MESHES[mesh]
    got = {}
    with D.fake_world(mesh_cfg.num_devices):
        for arch, sname, _ in cells():
            cell = D.Cell(get_config(arch), SHAPES[sname], mesh_cfg)
            got[f"{mesh}/{arch}/{sname}"] = _args_bytes(cell)
    want = {k: v for k, v in ref["shard_bytes"].items()
            if k.startswith(mesh + "/")}
    assert len(got) == 32
    assert got == want


# ---------------------------------------------------------------------------
# collectives against real gloo ranks
# ---------------------------------------------------------------------------
TINY_SHAPE = ShapeConfig("tiny_train", 16, 8, "train")
RANK_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1))}


def _tiny():
    from repro_torch.configs.tiny import TINY
    return TINY


RANK_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import test_torch_dryrun as M
    from repro_torch.configs.base import MeshConfig, TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import dryrun as D
    from repro_torch.runtime.train_loop import Trainer
    rank, world, store_path, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    res = {{}}
    for shape in M.RANK_MESHES[world]:
        cfg = M._tiny()
        tr = Trainer(cfg, M.TINY_SHAPE, MeshConfig(shape, ("data", "model")),
                     TrainConfig(), device="cpu")
        state = tr.init_state()
        tally = D.Tally()
        with D.counted_collectives(tally):
            tr.step_fn(state, lm_batch(cfg, M.TINY_SHAPE, 0, device="cpu"))
        res["x".join(map(str, shape))] = [tally.coll_bytes, tally.coll_counts]
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def gloo_counts(tmp_path_factory):
    """Rank 0's counted collectives of one real ``tiny`` step on each mesh
    of ``RANK_MESHES``, run by gloo ranks in subprocesses."""
    base = tmp_path_factory.mktemp("dryrun_gloo")
    script = base / "rank.py"
    script.write_text(RANK_SCRIPT.format(tests=str(ROOT / "tests")))
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs, outs = [], {}
    for world in RANK_MESHES:
        outs[world] = base / f"out{world}.json"
        store = base / f"store{world}"
        procs += [subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), str(store),
             str(outs[world])], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    return {w: json.loads(o.read_text()) for w, o in outs.items()}


@pytest.mark.parametrize("world,mesh", [(w, m) for w in RANK_MESHES
                                        for m in RANK_MESHES[w]])
def test_collective_bytes_equal_a_real_mesh_step(gloo_counts, world, mesh):
    mesh_cfg = MeshConfig(mesh, ("data", "model"))
    with D.fake_world(world):
        stats = D.trace_cell(_tiny(), TINY_SHAPE, mesh_cfg)
    want_bytes, want_counts = gloo_counts[world]["x".join(map(str, mesh))]
    assert stats["collective_bytes_by_kind"] == want_bytes
    assert stats["collective_counts"] == want_counts
    assert stats["collective_bytes"] == sum(want_bytes.values()) > 0


@pytest.mark.parametrize("arch", ["dense", "moe", "rwkv", "mamba"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_no_model_axis_gather_of_a_head_parallel_leaf(kind, arch):
    """On a fake (2, 2) mesh with ``fsdp`` on, a cell gathers its leaves'
    data-axis parts and no model-axis part.  Over the model group it makes
    only the collectives its design adds: a dense cell all-gathers nothing;
    an MoE cell its experts' outputs, an RWKV-6 cell its channel mix's
    receptance (one call a layer each); a Mamba cell all-gathers nothing
    and re-lays its stacked ``in_proj`` by one all-to-all (and its
    gradient by another in a train cell).  The tensor-parallel all-reduces
    are counted."""
    from repro_torch.configs.base import MambaConfig, MoEConfig, RWKVConfig
    extra = {"dense": {},
             "moe": dict(moe=MoEConfig(num_experts=4, top_k=2,
                                       d_ff_expert=32)),
             "rwkv": dict(mixer="rwkv6", rwkv=RWKVConfig(
                 head_size=16, decay_lora=8, mix_lora=8)),
             "mamba": dict(mixer="mamba", mamba=MambaConfig(d_state=4))}
    cfg = dataclasses.replace(_tiny(), fsdp=True, **extra[arch])
    shape = ShapeConfig("t", 16, 8, kind)
    with D.fake_world(MESH_2X2.num_devices):
        stats = D.trace_cell(cfg, shape, MESH_2X2)
        model = tuple(torch.distributed.get_process_group_ranks(
            D.Cell(cfg, shape, MESH_2X2).placement.group(("model",))))
    calls = stats["tally"].coll_calls
    over_model = [c for c in calls if c[0] == "all-gather" and c[2] == model]
    gathers = cfg.num_layers if arch in ("moe", "rwkv") else 0
    assert len(over_model) == gathers, over_model
    to_all = [c for c in calls if c[0] == "all-to-all"]
    assert all(c[2] == model for c in to_all)
    relays = 0 if arch != "mamba" else 2 if kind == "train" else 1
    assert len(to_all) == relays, to_all
    assert any(c[0] == "all-gather" and c[2] != model for c in calls)
    assert any(c[0] == "all-reduce" and c[2] == model for c in calls)
    assert stats["execution"] == D.EXECUTION


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_per_block_gathers_lower_the_peak_by_the_rule(kind, monkeypatch):
    """Llama-3's smoke config with ``fsdp`` on, six super-blocks, on a fake
    (2, 2) world: gathering the layers' data-axis parts one super-block at
    a time (``sharding.BlockGather``) lowers rank 0's traced peak, against
    the same trace with every leaf gathered whole, by at least the rule's
    share of the gathered stack ``G`` (the split leaves' bytes gathered
    over the data axis, the model-axis part kept): ``(n - 1) / n`` of it
    in a serving cell, where ``n`` blocks' gathered parameters become one
    block's; in a train cell also the whole-stack gradient and, with
    ``grad_accum > 1``, the whole-leaf accumulator, each ``G`` less the
    rank's slices ``L``."""
    from repro_torch import sharding as shard
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import transformer as T
    cfg = get_config("llama3-405b", smoke=True).with_(
        fsdp=True, num_layers=6, remat=True, remat_group=3)
    shape = ShapeConfig("t", 64, 8, kind)
    with D.fake_world(MESH_2X2.num_devices):
        per_block = D.trace_cell(cfg, shape, MESH_2X2)
        cell = D.Cell(cfg, shape, MESH_2X2)
        blocks = cell.blocks
        like, specs = ((cell.like.params, cell.specs.params)
                       if kind == "train" else (cell.like, cell.specs))
        sizes = dict(zip(MESH_2X2.axes, MESH_2X2.shape))
        local = gathered = 0
        for t, sp, p in zip(tree_leaves(like), tree_leaves(specs),
                            tree_leaves(blocks.plans)):
            if p.gather is None:
                continue
            n = int(np.prod(shard.local_shape(
                sp, t.shape, MESH_2X2, cell.placement.coord)))
            local += n * t.element_size()
            gathered += n * t.element_size() * int(np.prod(
                [sizes[a] for axes in p.axes for a in axes]))
        monkeypatch.setattr(shard.TreeSharding, "block_gather",
                            lambda self, keep_model=None: None)
        whole = D.trace_cell(cfg, shape, MESH_2X2)
    assert per_block["execution"] == D.EXECUTION
    assert whole["execution"] == D.EXECUTION_WHOLE
    n = cfg.num_layers // T.pattern_period(cfg)
    drop = whole["peak_bytes"] - per_block["peak_bytes"]
    want = (n - 1) * gathered               # times n, in integers
    if kind == "train":
        want += n * (gathered - local) * (1 + (cfg.grad_accum > 1))
    assert local and drop * n >= want, (drop, want / n, gathered, local)


# ---------------------------------------------------------------------------
# FLOPs and kernel calls against a real step
# ---------------------------------------------------------------------------
def _spied(name, real, calls):
    """``real`` run outside every dispatch mode (so outside the counter),
    forward and backward, recording ``(name, input shapes)``."""
    from torch.utils._python_dispatch import _disable_current_modes

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            calls.append((name, [tuple(a.shape) for a in args],
                          args[0].element_size()))
            with _disable_current_modes(), torch.enable_grad():
                ins = [a.detach().requires_grad_(a.is_floating_point())
                       for a in args]
                out = real(*ins)
            ctx.ins, ctx.outs = ins, out
            single = isinstance(out, torch.Tensor)
            ctx.single = single
            outs = (out,) if single else out
            res = tuple(o.detach() for o in outs)
            return res[0] if single else res

        @staticmethod
        def backward(ctx, *grads):
            calls.append((name + "_bwd", [tuple(a.shape) for a in ctx.ins],
                          ctx.ins[0].element_size()))
            outs = (ctx.outs,) if ctx.single else ctx.outs
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [a for a in ctx.ins if a.requires_grad]
            with _disable_current_modes():
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True))
            return tuple(next(got) if a.requires_grad else None
                         for a in ctx.ins)

    return lambda *args: Spy.apply(*args)


def _as_kernel_call(name, shapes, itemsize):
    """A spy record as the dry run's ``(name, shapes)``."""
    if name.startswith("flash_attention"):
        b, s, kvp, gp, hd = shapes[0]
        return (name, dict(b=b, s=s, kvp=kvp, gp=gp, hd=hd,
                           itemsize=itemsize))
    raise AssertionError(f"tiny calls no {name}")


def test_flops_and_kernel_calls_equal_a_real_step(tmp_path, monkeypatch):
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.train_loop import Trainer

    cfg, mesh_cfg = _tiny(), MeshConfig((1, 1), ("data", "model"))
    calls = []
    for name in ("flash_attention", "wkv", "selective_scan", "int8_matmul",
                 "paged_attention"):
        monkeypatch.setattr(kops, name, _spied(name, getattr(kops, name),
                                               calls))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        tr = Trainer(cfg, TINY_SHAPE, mesh_cfg, TrainConfig(), device="cpu")
        state = tr.init_state()
        batch = lm_batch(cfg, TINY_SHAPE, 0, device="cpu")
        counter = FlopCounterMode(display=False)
        with counter:
            tr.step_fn(state, batch)
    finally:
        dist.destroy_process_group()
    monkeypatch.undo()
    with D.fake_world(1):
        stats = D.trace_cell(cfg, TINY_SHAPE, mesh_cfg)
    assert calls, "tiny's step calls flash attention"
    assert stats["flops"] - stats["kernel_flops"] == \
        counter.get_total_flops()
    assert stats["tally"].kernel_calls == [_as_kernel_call(*c)
                                           for c in calls]


# ---------------------------------------------------------------------------
# the production mesh and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod,world,shape,axes", [
    (False, 256, (16, 16), ("data", "model")),
    (True, 512, (2, 16, 16), ("pod", "data", "model"))])
def test_make_production_mesh_on_a_fake_world(multi_pod, world, shape, axes):
    from repro_torch.launch.mesh import make_production_mesh
    with D.fake_world(world):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.mesh.shape) == shape
        assert mesh.mesh_dim_names == axes
        assert tuple(mesh.get_coordinate()) == (0,) * len(shape)


@pytest.mark.parametrize("multi_pod,world", [(False, 4), (False, 512),
                                             (True, 256)])
def test_make_production_mesh_refuses_another_world(multi_pod, world):
    from repro_torch.launch.mesh import make_production_mesh
    with D.fake_world(world):
        with pytest.raises(ValueError, match="need"):
            make_production_mesh(multi_pod=multi_pod)


def test_cli_writes_the_reference_keys(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        D.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                "--out", str(tmp_path)])
    assert done.value.code == 0
    assert "1/1 cells OK" in capsys.readouterr().out
    row = json.loads(
        (tmp_path / "stablelm-1.6b__decode_32k__single.json").read_text())
    assert REFERENCE_KEYS | {"execution", "fits_80gb"} <= set(row)
    assert row["execution"] == ("head-parallel compute on the model axis "
                                "(attention, MLPs, MoE, Mamba and RWKV-6 "
                                "mixers); data-axis parts gathered")
    assert set(row["roofline"]) == {
        "arch", "shape", "mesh", "chips", "hlo_gflops", "hlo_gbytes",
        "coll_gbytes", "compute_ms", "memory_ms", "collective_ms",
        "dominant", "model_gflops", "useful_ratio", "roofline_frac"}


def test_cli_lists_a_failed_cell_and_exits_1(tmp_path, capsys, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("no trace")
    monkeypatch.setattr(D, "trace_cell", broken)
    with pytest.raises(SystemExit) as done:
        D.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                "--out", str(tmp_path)])
    assert done.value.code == 1
    out = capsys.readouterr().out
    assert "0/1 cells OK" in out
    assert "FAIL stablelm-1.6b__decode_32k__single" in out


if __name__ == "__main__":
    _reference(sys.argv[1])
