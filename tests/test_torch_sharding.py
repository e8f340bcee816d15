"""The port's partition specs (``repro_torch.sharding``), cell structs
(``repro_torch.launch.specs``) and dry-run cells (``configs.cells``)
against the reference's, with no ranks.

Spec trees (params, data, cache, logits) are compared entry by entry, as
tuples, for every arch at full size on ``SINGLE_POD``, ``MULTI_POD`` and a
``(2, 2, 2)`` mesh, ``fsdp`` off and on, and under ``sharding_mode=
"fsdp"``; every spec divides its dims (the port's twin of
``tests/test_sharding_specs.py``).  ``shard_slices`` is held to
``NamedSharding(mesh, spec).devices_indices_map(shape)`` for the device at
each mesh coordinate, in a subprocess with eight forced host devices.

The reference's ``model_init`` traces one ``superblock_init`` a
super-block (126 for Llama-3 405B, 40 s under ``jax.eval_shape``).  Its
structs are therefore taken at one super-block, with each stacked leaf's
leading dim set to the arch's super-block count, which is what
``model_init``'s ``jnp.stack`` of identical trees gives
(``src/repro/models/transformer.py:94-95``);
``test_one_superblock_shortcut_equals_the_full_trace`` holds that
shortcut to the full trace for the archs that trace in seconds.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import sharding as jshard
from repro.configs import ARCH_NAMES, SHAPES as JSHAPES, cells as jcells
from repro.configs import get_config as jget
from repro.configs.base import MeshConfig as JMesh
from repro.launch import specs as JS
from repro.models import transformer as JT
from repro_torch import sharding as tshard
from repro_torch.checkpoint.manager import _items
from repro_torch.configs import SHAPES, cells as tcells
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.launch import specs as TS

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": SINGLE_POD, "multi": MULTI_POD,
          "222": MeshConfig((2, 2, 2), ("pod", "data", "model"))}
TPS = (1, 16)
SHORTCUT_ARCHS = ("stablelm-1.6b", "rwkv6-3b", "jamba-v0.1-52b",
                  "olmoe-1b-7b")
# (2, 4), (4, 2) and (2, 2, 2) meshes over eight host devices
PLACE_MESHES = {"2x4": ((2, 4), ("data", "model")),
                "4x2": ((4, 2), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PLACE_CONFIGS = ("tiny_dense", "rwkv6-smoke")


def _jmesh(m: MeshConfig) -> JMesh:
    return JMesh(tuple(m.shape), tuple(m.axes))


# ---------------------------------------------------------------------------
# flattening both packages' trees to {checkpoint key: leaf}
# ---------------------------------------------------------------------------
def _jkey(path) -> str:
    out = []
    for p in path:
        if isinstance(p, jax.tree_util.DictKey):
            out.append(str(p.key))
        elif isinstance(p, jax.tree_util.GetAttrKey):
            out.append("." + p.name)
        else:
            out.append(str(p.idx))
    return "/".join(out)


def _jflat(tree, is_leaf=None) -> dict:
    return {_jkey(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _jstructs(tree) -> dict:
    return {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _jflat(tree).items()}


def _tstructs(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _items(tree)}


def _jspecs(tree) -> dict:
    return {k: tuple(v) for k, v in
            _jflat(tree, lambda x: isinstance(x, JP)).items()}


def _tspecs(tree) -> dict:
    return {k: tuple(v) for k, v in _items(tree)}


# ---------------------------------------------------------------------------
# the reference's structs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, tp: int):
    """``JS.param_structs(cfg, tp)`` through the one-super-block shortcut
    (module docstring)."""
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


def _ref_param_structs(arch: str, tp: int, dtype=None):
    """``JS.param_structs`` on the shortcut's tree (its dtype rule)."""
    shapes = _ref_params(arch, tp)
    if dtype is None:
        return shapes
    return jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(
            s.shape, dtype if jnp.issubdtype(s.dtype, jnp.floating)
            else s.dtype), shapes)


def _skip(cfg, shape) -> bool:
    return shape.name == "long_500k" and not cfg.supports_long_context()


# ---------------------------------------------------------------------------
# launch/specs and configs.cells
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SHORTCUT_ARCHS)
def test_one_superblock_shortcut_equals_the_full_trace(arch):
    assert _jstructs(JS.param_structs(jget(arch), 16)) == \
        _jstructs(_ref_params(arch, 16))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_structs_equal_jax_eval_shape(arch, tp, monkeypatch):
    jcfg, tcfg = jget(arch), tget(arch)
    assert _tstructs(TS.param_structs(tcfg, tp)) == \
        _jstructs(_ref_params(arch, tp))
    assert _tstructs(TS.param_structs(tcfg, tp, torch.bfloat16)) == \
        _jstructs(_ref_param_structs(arch, tp, jnp.bfloat16))
    monkeypatch.setattr(JS, "param_structs",
                        lambda cfg, tp, dtype=None: _ref_param_structs(
                            arch, tp, dtype))
    q = _tstructs(TS.param_structs_quantized(tcfg, tp))
    assert q == _jstructs(JS.param_structs_quantized(jcfg, tp))
    assert any(d == "int8" for _, d in q.values())
    for name, shape in SHAPES.items():
        if _skip(jcfg, JSHAPES[name]):
            continue
        assert TS.token_len(tcfg, shape) == JS.token_len(jcfg,
                                                         JSHAPES[name])
        got = TS.input_specs(tcfg, shape, tp)
        assert _tstructs(got) == \
            _jstructs(JS.input_specs(jcfg, JSHAPES[name], tp)), name
        assert all(t.device.type == "meta" for _, t in _items(got))


@pytest.mark.parametrize("include_skipped", (False, True))
def test_cells_equal_the_reference(include_skipped):
    got = tcells(include_skipped)
    assert got == jcells(include_skipped)
    assert any(skip for _, _, skip in got) == include_skipped


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fsdp", (False, True), ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, mesh, fsdp):
    m = MESHES[mesh]
    tcfg, jcfg = tget(arch).with_(fsdp=fsdp), jget(arch).with_(fsdp=fsdp)
    got = tshard.param_specs(tcfg, TS.param_structs(tcfg, m.tp), m)
    want = jshard.param_specs(jcfg, _ref_params(arch, m.tp), _jmesh(m))
    assert _tspecs(got) == _jspecs(want)
    assert all(isinstance(s, tshard.PartitionSpec) for _, s in _items(got))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_fsdp_mode_param_specs_equal_the_reference(arch, mesh):
    """``sharding_mode="fsdp"``: ZeRO-3 over every axis for a dense stack
    (an MoE stack keeps the tp tables)."""
    m = MESHES[mesh]
    tcfg = tget(arch).with_(sharding_mode="fsdp")
    jcfg = jget(arch).with_(sharding_mode="fsdp")
    got = tshard.param_specs(tcfg, TS.param_structs(tcfg, m.tp), m)
    want = jshard.param_specs(jcfg, _ref_params(arch, m.tp), _jmesh(m))
    assert _tspecs(got) == _jspecs(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_data_cache_logits_specs_equal_the_reference(arch, mesh):
    m, jm = MESHES[mesh], _jmesh(MESHES[mesh])
    for mode in ("tp", "fsdp"):
        tcfg = tget(arch).with_(sharding_mode=mode)
        jcfg = jget(arch).with_(sharding_mode=mode)
        for name, shape in SHAPES.items():
            if _skip(jcfg, JSHAPES[name]):
                continue
            js = JSHAPES[name]
            assert _tspecs(tshard.data_specs(tcfg, shape, m)) == \
                _jspecs(jshard.data_specs(jcfg, js, jm)), (mode, name)
            assert tuple(tshard.logits_spec(shape, m)) == \
                tuple(jshard.logits_spec(js, jm))
            if shape.kind == "decode":
                got = tshard.cache_specs(
                    tcfg, TS.cache_structs(tcfg, shape, m.tp), shape, m)
                want = jshard.cache_specs(
                    jcfg, JS.cache_structs(jcfg, js, m.tp), js, jm)
                assert _tspecs(got) == _jspecs(want), (mode, name)


def _check_divisible(spec_tree, shape_tree, mesh_cfg, ctx):
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    specs, shapes = dict(_items(spec_tree)), dict(_items(shape_tree))
    assert sorted(specs) == sorted(shapes), ctx
    for k, leaf in shapes.items():
        assert not tshard.uneven_dims(specs[k], leaf.shape, mesh_cfg), \
            (ctx, k, tuple(leaf.shape), specs[k], sizes)


@pytest.mark.parametrize("mesh", ("single", "multi"))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_divide(arch, mesh):
    """Every param, data and cache spec of every full-size arch divides
    its dims on both production meshes."""
    m = MESHES[mesh]
    cfg = tget(arch)
    tree = TS.param_structs(cfg, m.tp)
    _check_divisible(tshard.param_specs(cfg, tree, m), tree, m, arch)
    for shape in SHAPES.values():
        if _skip(cfg, shape):
            continue
        _check_divisible(tshard.data_specs(cfg, shape, m),
                         TS.batch_specs(cfg, shape), m, (arch, shape.name))
        if shape.kind == "decode":
            cache = TS.cache_structs(cfg, shape, m.tp)
            _check_divisible(tshard.cache_specs(cfg, cache, shape, m),
                             cache, m, (arch, shape.name, "cache"))


def test_batch_axes_fallback():
    assert tshard.batch_axes(1, SINGLE_POD) is None
    assert tshard.batch_axes(128, MULTI_POD) == ("pod", "data")
    assert tshard.batch_axes(8, MULTI_POD) == ("pod",)
    for b in (1, 2, 3, 8, 48, 128, 512):
        for m in MESHES.values():
            for inc in (False, True):
                assert tshard.batch_axes(b, m, inc) == \
                    jshard.batch_axes(b, _jmesh(m), inc)


def test_meshes_need_their_ranks():
    """``launch/mesh`` builds nothing on import and refuses a mesh the
    world cannot fill, in the reference's words."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh
    assert not dist.is_initialized()
    assert tmesh.production_mesh_config() == SINGLE_POD
    assert tmesh.production_mesh_config(multi_pod=True) == MULTI_POD
    for m in MESHES.values():
        with pytest.raises(ValueError, match=f"need {m.num_devices} "
                                             f"devices, have 1"):
            tmesh.make_mesh_from_config(m)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh_from_config(MeshConfig((1, 1), ("data", "model")))


def test_unshard_refuses_axes_out_of_the_mesh_order():
    """A gather's group runs in the mesh's axis order, so a dim split over
    axes in another order cannot be put back together from it."""
    m = MeshConfig((2, 2), ("data", "pod"))
    spec = tshard.PartitionSpec(("pod", "data"))
    with pytest.raises(ValueError, match="not in the mesh's order"):
        tshard.unshard(torch.zeros(2, 4), spec, (8, 4), m, None)


def test_partition_spec_reads_as_jax_does():
    P = tshard.PartitionSpec
    for entries in [(), (None,), ("data", None), (("pod", "data"), None),
                    (("pod",), "model"), (None, ["data", "model"])]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P(("pod",), None) == P("pod", None)
    assert hash(P("data")) == hash(P(("data",)))
    with pytest.raises(AttributeError):
        P("data").x = 1
    spec = P(None, ("pod", "data"), "model")
    assert tshard.dim_axes(spec, 4) == ((), ("pod", "data"), ("model",), ())


# ---------------------------------------------------------------------------
# placement: shard_slices against devices_indices_map
# ---------------------------------------------------------------------------
def _place_cfg(name, model_config, get_config):
    """``tiny_dense`` with ``fsdp`` (so dims split over axis tuples), or
    the RWKV-6 smoke config, as either package's config."""
    if name == "tiny_dense":
        return model_config(
            name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            remat=False, fsdp=True)
    return get_config("rwkv6-3b", smoke=True)


def _reference_maps(out):
    """Run as ``python tests/test_torch_sharding.py OUT.json`` with eight
    host devices: every leaf's shard ranges by mesh coordinate."""
    from jax.sharding import NamedSharding

    import repro.configs as jc
    import repro.configs.base as jb
    res = {}
    for mname, (shape, axes) in PLACE_MESHES.items():
        mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:8])
        mcfg = jb.MeshConfig(shape, axes)
        coords = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        for cname in PLACE_CONFIGS:
            cfg = _place_cfg(cname, jb.ModelConfig, jc.get_config)
            structs = JS.param_structs(cfg, mcfg.tp)
            specs = jshard.param_specs(cfg, structs, mcfg)
            data = jshard.data_specs(cfg, jb.ShapeConfig("t", 32, 8,
                                                         "train"), mcfg)
            leaves = {k: (tuple(s.shape), _jspecs(specs)[k])
                      for k, s in _jflat(structs).items()}
            leaves["tokens"] = ((8, 32), tuple(data["tokens"]))
            entry = {}
            for k, (shp, spec) in leaves.items():
                idx = NamedSharding(mesh, JP(*spec)).devices_indices_map(shp)
                entry[k] = {"shape": list(shp), "spec": repr(spec), "coords": {
                    ",".join(map(str, coords[d.id])):
                        [list(sl.indices(n)[:2]) for sl, n in zip(ix, shp)]
                    for d, ix in idx.items()}}
            res[f"{mname}/{cname}"] = entry
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def ref_maps(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding_ref") / "maps.json"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_force_host_platform_device_count=8").strip()
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("cname", PLACE_CONFIGS)
@pytest.mark.parametrize("mname", list(PLACE_MESHES))
def test_shard_slices_equal_devices_indices_map(ref_maps, mname, cname):
    import repro_torch.configs as tc
    import repro_torch.configs.base as tb
    shape, axes = PLACE_MESHES[mname]
    mcfg = MeshConfig(shape, axes)
    cfg = _place_cfg(cname, tb.ModelConfig, tc.get_config)
    structs = TS.param_structs(cfg, mcfg.tp)
    specs = dict(_items(tshard.param_specs(cfg, structs, mcfg)))
    specs["tokens"] = tshard.data_specs(
        cfg, tb.ShapeConfig("t", 32, 8, "train"), mcfg)["tokens"]
    want = ref_maps[f"{mname}/{cname}"]
    assert sorted(specs) == sorted(want)
    split = 0
    for k, w in want.items():
        shp = tuple(w["shape"])
        assert repr(tuple(specs[k])) == w["spec"], k
        full = torch.arange(int(np.prod(shp))).reshape(shp)
        for cstr, ranges in w["coords"].items():
            coord = tuple(int(c) for c in cstr.split(","))
            sl = tshard.shard_slices(specs[k], shp, mcfg, coord)
            assert [[s.start, s.stop] for s in sl] == ranges, (k, coord)
            assert tshard.local_shape(specs[k], shp, mcfg, coord) == \
                tuple(b - a for a, b in ranges)
            part = tshard.shard(full, specs[k], mcfg, coord)
            assert torch.equal(part, full[sl])
            split += part.numel() < full.numel()
    assert split          # some leaf is split on every mesh


if __name__ == "__main__":
    _reference_maps(sys.argv[1])
