"""Head-parallel compute on the model axis (``core/collectives.py``'s model
group) against the same functions on one device.

One world of two gloo ranks (subprocesses joined through a ``FileStore``
under ``tmp_path``, torch at one thread a rank) runs every check's split
side inside ``collectives.model_group``, each rank on its part of the
weights; the one-device side runs once in the test process and is cached
for the module.  Inputs come from ``numpy`` seeds, weights from the
port's seeded init (the one-device ``Trainer`` and the reference are held
together in ``tests/test_torch_sharded_train.py``).  Checked:

* the conjugate pair: ``to_model`` is the identity forward and sums the
  ranks' gradients, ``from_model`` sums the ranks' parts and passes the
  gradient through;
* a row-parallel ``"quant"`` ``pdot`` (per-channel and per-tensor weight
  scales) bit-equal to the unsplit product, a column-parallel one equal to
  its columns, and the fake-quant scales of split weights and inputs equal
  to the whole tensors';
* the vocab-parallel ``embed`` bit-equal (values and the table's
  gradient), the vocab-parallel cross-entropy and its gradient within
  ``LOSS_TOL``;
* ``attention_apply`` (k, v heads bit-equal; the q/k norms' replicated
  scales get every rank's heads' gradient) and ``moe_apply`` (flat and
  per-row dispatch, a shared expert; aux loss bit-equal) within
  ``F32_TOL``, their gradients too, and every gradient of an f32
  ``Trainer`` step of ``olmoe-smoke`` on (1, 2);
* ``T.forward`` and four ``T.decode_step`` on the dense ``KVCache`` at
  (1, 2): f32 logits within ``LOGITS_TOL``; under the ``"mpai"`` serving
  plan every int8 layer's output bit-equal to one device's; the residual
  stream after every layer bit-identical on both ranks;
* a (1, 2) ``Trainer`` step all-gathers no model-axis part of a
  head-parallel leaf (``launch.dryrun.counted_collectives``).

Tolerances: a row-parallel f32 product and the vocab-parallel
log-sum-exp add the same f32 terms as one device in another order, a few
ulps of the largest term (measured 1-3e-7 relative); the bounds leave 10x.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sharding as shard
from repro_torch.configs.base import MeshConfig, ModelConfig, MoEConfig
from repro_torch.core import collectives, qat
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.quantization import pdot, quantize
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.layers import cross_entropy, embed

ROOT = Path(__file__).resolve().parents[1]
RANKS = 2
F32_TOL = 1e-5          # relative to the largest |value| of the tensor
LOSS_TOL = 1e-6
LOGITS_TOL = 1e-5
MESH = MeshConfig((1, RANKS), ("data", "model"))
DECODE_STEPS = 4


def _model_cfg():
    return ModelConfig(name="hp", family="dense", num_layers=3, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                       qk_norm=True, remat=False)


MOE = MoEConfig(num_experts=4, top_k=2, d_ff_expert=16, shared_d_ff=32)
INT8_PT = PrecisionPolicy(PrecisionPolicy.int8().precision, "quant",
                          per_channel=False)


def _inputs() -> dict:
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    return {"x": t(4, 8), "w": t(4, 8), "p": t(4, 8), "g": t(4, 8),
            "xq": t(6, 16), "wq": t(16, 12),
            "table": t(32, 8), "eg": t(2, 5, 8),
            "tokens": torch.tensor(rng.randint(0, 32, (2, 5))),
            "logits": t(2, 5, 32) * 3,
            "labels": torch.tensor(rng.randint(0, 32, (2, 5))),
            "xa": t(2, 8, 32), "xm": t(2, 8, 16), "xr": t(2, 1100, 16),
            "gm": t(2, 8, 16), "gr": t(2, 1100, 16),
            "prompt": torch.tensor(rng.randint(0, 64, (2, 6))),
            "dec": torch.tensor(rng.randint(0, 64, (2, DECODE_STEPS)))}


def _part(t: torch.Tensor, dim: int, rank: int, ranks: int) -> torch.Tensor:
    n = t.shape[dim] // ranks
    return t.narrow(dim, rank * n, n).contiguous()


def _local_tree(params, cfg, rank: int, ranks: int):
    """The rank's part of each head-parallel leaf of ``params`` on (1,
    ranks), the other leaves whole."""
    if ranks == 1:
        return params
    specs = shard.param_specs(cfg, params, MESH)
    hp = shard.head_parallel(cfg, params, MESH)
    return tree_map(lambda t, sp, h: shard.shard(
        t, sp, MESH, {"data": 0, "model": rank}) if h else t,
        params, specs, hp)


def _leaf(out, key, t):
    out[key] = t.detach().float().numpy().copy()


def _pair(out, inp, rank):
    x = inp["x"].clone().requires_grad_(True)
    y = collectives.to_model(x) * float(rank + 1)
    (y * inp["w"]).sum().backward()
    _leaf(out, "to_model/value", y)
    _leaf(out, "to_model/grad", x.grad)
    p = (inp["p"] * float(rank + 1)).requires_grad_(True)
    z = collectives.from_model(p)
    (z * inp["g"]).sum().backward()
    _leaf(out, "from_model/value", z)
    _leaf(out, "from_model/grad", p.grad)


def _products(out, inp, rank, ranks):
    x, w = inp["xq"], inp["wq"]
    split = ranks > 1
    for name, pol in (("per_channel", PrecisionPolicy.int8()),
                      ("per_tensor", INT8_PT)):
        _leaf(out, f"pdot/{name}/row", pdot(_part(x, 1, rank, ranks),
                                            _part(w, 0, rank, ranks), pol,
                                            split="row"))
        _leaf(out, f"pdot/{name}/col", pdot(x, _part(w, 1, rank, ranks),
                                            pol, split="col"))
    _leaf(out, "scale/w_row", quantize(_part(w, 0, rank, ranks), -1,
                                       split=split).scale)
    _leaf(out, "scale/w_tensor", quantize(_part(w, 1, rank, ranks),
                                          split=split).scale)
    _leaf(out, "scale/x_row", quantize(_part(x, 1, rank, ranks),
                                       activation=True, split=split).scale)
    _leaf(out, "pdot/fake/row", pdot(_part(x, 1, rank, ranks),
                                     _part(w, 0, rank, ranks),
                                     PrecisionPolicy.int8_qat(), split="row"))


def _vocab(out, inp, rank, ranks):
    table = _part(inp["table"], 0, rank, ranks).requires_grad_(True)
    e = embed(table, inp["tokens"], torch.float32)
    (e * inp["eg"]).sum().backward()
    _leaf(out, "embed/f32", e)
    _leaf(out, "embed/grad", table.grad)
    _leaf(out, "embed/bf16", embed(table.detach(), inp["tokens"]))
    logits = _part(inp["logits"], 2, rank, ranks).requires_grad_(True)
    loss = cross_entropy(logits, inp["labels"])
    loss.backward()
    _leaf(out, "ce/loss", loss)
    _leaf(out, "ce/grad", logits.grad)


def _attention_moe(out, inp, rank, ranks):
    cfg = _model_cfg()
    whole = tree_map(lambda a: a[0], attn.attention_init(
        cfg, 1, torch.Generator().manual_seed(1), "cpu", RANKS))
    cols = ("wq", "wk", "wv")
    params = {k: (_part(v, 1, rank, ranks) if k in cols else
                  _part(v, 0, rank, ranks) if k == "wo" else v)
              for k, v in whole.items()}
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    params = tree_map(lambda a: a.clone().requires_grad_(True), params)
    x = inp["xa"].clone().requires_grad_(True)
    o, k, v = attn.attention_apply(params, cfg, x, pos,
                                   PrecisionPolicy.fp32())
    (o * inp["xa"].flip(0)).sum().backward()
    for key, t in (("out", o), ("k", k), ("v", v), ("dx", x.grad),
                   ("dwq", params["wq"].grad), ("dwo", params["wo"].grad),
                   ("dq_norm", params["q_norm"]["scale"].grad),
                   ("dk_norm", params["k_norm"]["scale"].grad)):
        _leaf(out, f"attention/{key}", t)
    whole = tree_map(lambda a: a[0], moe_mod.moe_init(
        1, 16, MOE, True, torch.Generator().manual_seed(2), "cpu"))
    experts = {k: _part(whole[k], 0, rank, ranks)
               for k in ("w_in", "w_gate", "w_out")}
    sh = whole["shared"]
    shared = {"w_in": _part(sh["w_in"], 1, rank, ranks),
              "w_gate": _part(sh["w_gate"], 1, rank, ranks),
              "w_out": _part(sh["w_out"], 0, rank, ranks)}
    for path, xk, gk in (("flat", "xm", "gm"), ("per_row", "xr", "gr")):
        for pname, pol in (("f32", PrecisionPolicy.fp32()),
                           ("fake", PrecisionPolicy.int8_qat())):
            leaves = {**experts, "shared": shared, "router": whole["router"]}
            leaves = tree_map(lambda a: a.clone().requires_grad_(True),
                              leaves)
            x = inp[xk].clone().requires_grad_(True)
            y, aux = moe_mod.moe_apply(leaves, MOE, x, policy=pol)
            ((y.float() * inp[gk]).sum() + aux).backward()
            key = f"moe/{path}/{pname}"
            _leaf(out, f"{key}/out", y)
            _leaf(out, f"{key}/aux", aux)
            _leaf(out, f"{key}/dx", x.grad)
            for name in ("w_in", "w_out", "router"):
                _leaf(out, f"{key}/d{name}", leaves[name].grad)
            _leaf(out, f"{key}/dshared_w_out", leaves["shared"]["w_out"].grad)


def _model(out, inp, rank, ranks):
    cfg = _model_cfg()
    whole = T.model_init(cfg, torch.Generator().manual_seed(3), "cpu", RANKS)
    params = _local_tree(whole, cfg, rank, ranks)
    plans = {"f32": PartitionPlan.uniform(cfg.num_layers,
                                          PrecisionPolicy.fp32()),
             "mpai": qat.serve_plan(PartitionPlan.mpai(cfg.num_layers))}
    real = T._sublayer_apply
    for pname, plan in plans.items():
        stream = []

        def spy(*args, **kw):
            x, new, aux = real(*args, **kw)
            stream.append(x.detach().float().clone())
            return x, new, aux
        T._sublayer_apply = spy
        try:
            with torch.no_grad():
                cache = T.init_cache(cfg, 2, 16, RANKS, device="cpu")
                logits = [T.forward(params, cfg, inp["prompt"], plan, RANKS,
                                    cache=cache).logits]
                for i in range(DECODE_STEPS):
                    logits.append(T.decode_step(
                        params, cfg, inp["dec"][:, i:i + 1], cache, plan,
                        RANKS).logits)
        finally:
            T._sublayer_apply = real
        out[f"model/{pname}/cache_heads"] = np.array(
            cache["sub_0"].k.shape[-2])
        for i, lg in enumerate(logits):
            _leaf(out, f"model/{pname}/logits/{i}", lg)
        for i, x in enumerate(stream):
            _leaf(out, f"model/{pname}/stream/{i}", x)


def _step_collectives(out, rank):
    """One (1, 2) ``Trainer`` step of a dense and an MoE ``tiny``: every
    all-gather's operand shape and whether it is over the model group,
    and the local shapes of the head-parallel leaves."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.launch import dryrun as D
    from repro_torch.runtime.train_loop import Trainer
    shape = ShapeConfig("t", 16, 4, "train")
    base = dict(family="dense", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=64, vocab_size=64, remat=False,
                fsdp=True)
    for name, cfg in (("dense", ModelConfig(name="hp", **base)),
                      ("moe", ModelConfig(name="hpmoe", moe=MOE, **base))):
        tr = Trainer(cfg, shape, MESH, TrainConfig(), device="cpu")
        st = tr.init_state()
        tally = D.Tally()
        with D.counted_collectives(tally):
            tr.step_fn(st, lm_batch(cfg, shape, 0, device="cpu"))
        model = tuple(torch.distributed.get_process_group_ranks(
            tr.placement.group((shard.MODEL,))))
        gathers = [(shp, ranks == model) for kind, shp, ranks
                   in tally.coll_calls if kind == "all-gather"]
        out[f"step/{name}/gathers"] = np.array(
            [list(s) + [-1] * (5 - len(s)) + [int(m)] for s, m in gathers]
            or np.zeros((0, 6)), dtype=np.int64)
        leaves = [list(t.shape) + [-1] * (5 - t.ndim) for t, h in zip(
            tree_leaves(st.params), tree_leaves(tr.head_parallel)) if h]
        out[f"step/{name}/hp_shapes"] = np.array(leaves, dtype=np.int64)
        out[f"step/{name}/all_reduces"] = np.array(
            sum(kind == "all-reduce" for kind, _, _ in tally.coll_calls))


def _trainer_grads(out, rank: int, ranks: int):
    """One f32 ``Trainer`` step of ``olmoe-smoke`` (q/k norms, MoE, remat)
    at one layer, on one device or on (1, ``ranks``): each gradient as
    AdamW gets it (the rank's parts on the mesh)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import Trainer
    cfg = get_config("olmoe-1b-7b", smoke=True).with_(num_layers=1,
                                                      remat=True)
    shape = ShapeConfig("t", 64, 2, "train")
    tr = Trainer(cfg, shape, MeshConfig((1, ranks), ("data", "model")),
                 TrainConfig(), plan=PartitionPlan.uniform(
                     1, PrecisionPolicy.fp32()), device="cpu")
    seen = []
    real = adamw.apply_updates

    def spy(params, grads, *a, **kw):
        seen.append([g.clone() for g in tree_leaves(grads)])
        return real(params, grads, *a, **kw)
    adamw.apply_updates = spy
    try:
        tr.step_fn(tr.init_state(), lm_batch(cfg, shape, 0, device="cpu"))
    finally:
        adamw.apply_updates = real
    for i, g in enumerate(seen[0]):
        _leaf(out, f"trainer/grad/{i}", g)


def _compute(rank: int, ranks: int) -> dict:
    """Every check's values on rank ``rank`` of ``ranks`` (inside the model
    group when ``ranks > 1``; one device otherwise)."""
    inp, out = _inputs(), {}
    group = torch.distributed.group.WORLD if ranks > 1 else None
    with collectives.model_group(group, ranks, rank):
        _pair(out, inp, rank)
        _products(out, inp, rank, ranks)
        _vocab(out, inp, rank, ranks)
        _attention_moe(out, inp, rank, ranks)
        _model(out, inp, rank, ranks)
    _trainer_grads(out, rank, ranks)
    if ranks > 1:
        _step_collectives(out, rank)
    return out


def _rank(rank: int, d: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(d, "store"), RANKS),
        rank=rank, world_size=RANKS)
    try:
        np.savez(os.path.join(d, f"rank{rank}.npz"), **_compute(rank, RANKS))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(one device, [rank results])``: the ranks run as subprocesses
    while the one-device side runs here."""
    d = tmp_path_factory.mktemp("head_parallel")
    path = os.pathsep.join([str(ROOT / "src"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _compute(0, 1)
    finally:
        torch.set_num_threads(threads)
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    return one, [dict(np.load(d / f"rank{r}.npz")) for r in range(RANKS)]


def _cat(ranks, key, dim):
    return np.concatenate([r[key] for r in ranks], axis=dim)


def _close(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
def test_conjugate_pair_values_and_gradients(runs):
    _, ranks = runs
    inp = _inputs()
    x, w, p, g = (inp[k].numpy() for k in ("x", "w", "p", "g"))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["to_model/value"], x * (r + 1))
        # the gradient of each rank's use, summed over the ranks
        np.testing.assert_allclose(got["to_model/grad"], w * 3, rtol=1e-6)
        np.testing.assert_allclose(got["from_model/value"], p * 3,
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["from_model/grad"], g)
    np.testing.assert_array_equal(ranks[0]["from_model/value"],
                                  ranks[1]["from_model/value"])


@pytest.mark.parametrize("scales", ["per_channel", "per_tensor"])
def test_int8_products_split_are_bit_equal(runs, scales):
    one, ranks = runs
    for got in ranks:
        np.testing.assert_array_equal(got[f"pdot/{scales}/row"],
                                      one[f"pdot/{scales}/row"])
    np.testing.assert_array_equal(_cat(ranks, f"pdot/{scales}/col", 1),
                                  one[f"pdot/{scales}/col"])


def test_fake_quant_scales_of_split_tensors_equal_the_whole(runs):
    one, ranks = runs
    for got in ranks:
        for key in ("scale/w_row", "scale/w_tensor", "scale/x_row"):
            np.testing.assert_array_equal(got[key], one[key])
        # the f32 partials' sum rounds to bf16 once, as one product does
        _close(got["pdot/fake/row"], one["pdot/fake/row"], 2 ** -8)


def test_vocab_parallel_embedding_is_bit_equal(runs):
    one, ranks = runs
    for got in ranks:
        np.testing.assert_array_equal(got["embed/f32"], one["embed/f32"])
        np.testing.assert_array_equal(got["embed/bf16"], one["embed/bf16"])
    np.testing.assert_array_equal(_cat(ranks, "embed/grad", 0),
                                  one["embed/grad"])


def test_vocab_parallel_loss_and_gradient(runs):
    one, ranks = runs
    for got in ranks:
        _close(got["ce/loss"], one["ce/loss"], LOSS_TOL, "loss")
    _close(_cat(ranks, "ce/grad", 2), one["ce/grad"], LOSS_TOL, "grad")


def test_head_local_attention(runs):
    """Forward and backward: the replicated q/k norm scales' gradients sum
    over both ranks' heads (through ``to_model``)."""
    one, ranks = runs
    for got in ranks:
        for key in ("out", "dx", "dq_norm", "dk_norm"):
            _close(got[f"attention/{key}"], one[f"attention/{key}"], F32_TOL,
                   key)
    for key in ("attention/k", "attention/v"):
        np.testing.assert_array_equal(_cat(ranks, key, 2), one[key])
    _close(_cat(ranks, "attention/dwq", 1), one["attention/dwq"], F32_TOL)
    _close(_cat(ranks, "attention/dwo", 0), one["attention/dwo"], F32_TOL)


def test_a_trainer_step_gives_one_devices_gradients(runs):
    """``olmoe-smoke`` (q/k norms, expert-parallel MoE, remat) on (1, 2):
    every gradient slice AdamW gets equals one device's slice."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.train_loop import Trainer
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    one, ranks = runs
    cfg = get_config("olmoe-1b-7b", smoke=True).with_(num_layers=1,
                                                      remat=True)
    like = Trainer(cfg, ShapeConfig("t", 64, 2, "train"),
                   MeshConfig((1, 1), ("data", "model")), TrainConfig(),
                   device="cpu").state_like().params
    specs = tree_leaves(shard.param_specs(cfg, like, MESH))
    n = sum(k.startswith("trainer/grad/") for k in one)
    assert n == len(specs)
    for r, got in enumerate(ranks):
        for i, sp in enumerate(specs):
            want = one[f"trainer/grad/{i}"]
            sl = shard.shard_slices(sp, want.shape, MESH,
                                    {"data": 0, "model": r})
            _close(got[f"trainer/grad/{i}"], want[sl], F32_TOL, i)


@pytest.mark.parametrize("path", ["flat", "per_row"])
@pytest.mark.parametrize("pname", ["f32", "fake"])
def test_expert_parallel_moe(runs, path, pname):
    one, ranks = runs
    key = f"moe/{path}/{pname}"
    # a bf16 expert product (the fake-quant plan) rounds as one device's;
    # the shared MLP's row-parallel sum and the gradients' all-reduce order
    # move the rest by f32 rounding
    tol = F32_TOL if pname == "f32" else 2 ** -7
    for got in ranks:
        np.testing.assert_array_equal(got[f"{key}/aux"], one[f"{key}/aux"])
        _close(got[f"{key}/out"], one[f"{key}/out"], tol, "out")
        _close(got[f"{key}/dx"], one[f"{key}/dx"], tol, "dx")
        _close(got[f"{key}/drouter"], one[f"{key}/drouter"], tol, "router")
    for name in ("w_in", "w_out"):
        _close(_cat(ranks, f"{key}/d{name}", 0), one[f"{key}/d{name}"], tol,
               name)
    _close(_cat(ranks, f"{key}/dshared_w_out", 0),
           one[f"{key}/dshared_w_out"], tol, "shared")


def test_forward_and_decode_logits_on_1x2(runs):
    one, ranks = runs
    for got in ranks:
        assert int(got["model/f32/cache_heads"]) * RANKS == \
            int(one["model/f32/cache_heads"])
    for i in range(DECODE_STEPS + 1):
        key = f"model/f32/logits/{i}"
        _close(_cat(ranks, key, 2), one[key], LOGITS_TOL, key)
        got = _cat(ranks, f"model/mpai/logits/{i}", 2)
        assert np.isfinite(got).all()


def test_int8_layers_of_the_mpai_serving_plan_are_bit_equal(runs):
    """Layers 0 and 1 run int8 (``PartitionPlan.mpai(3)``, served), layer
    2 bf16: every int8 layer's output, prefill and each decode step,
    equals one device's bit for bit."""
    one, ranks = runs
    layers = _model_cfg().num_layers
    keys = [k for k in one if k.startswith("model/mpai/stream/")]
    assert len(keys) == layers * (DECODE_STEPS + 1)
    int8 = [k for k in keys if int(k.rsplit("/", 1)[1]) % layers < layers - 1]
    for got in ranks:
        for k in int8:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)


@pytest.mark.parametrize("pname", ["f32", "mpai"])
def test_residual_stream_is_identical_on_both_model_ranks(runs, pname):
    _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith(f"model/{pname}/stream/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_a_step_gathers_no_model_axis_part_of_a_head_parallel_leaf(runs,
                                                                    name):
    """On (1, 2) no leaf is split over data: a dense step all-gathers
    nothing; an MoE step all-gathers its experts' outputs (one call a
    layer, over the model group) and no leaf; the TP all-reduces run."""
    _, ranks = runs
    for got in ranks:
        gathers = got[f"step/{name}/gathers"]
        leaves = {tuple(s) for s in got[f"step/{name}/hp_shapes"]}
        assert not any(tuple(g[:5]) in leaves for g in gathers)
        assert len(gathers) == (0 if name == "dense" else 2)
        assert int(got[f"step/{name}/all_reduces"]) > 0


if __name__ == "__main__":
    _rank(int(sys.argv[1]), sys.argv[2])
