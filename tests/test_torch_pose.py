"""The port's UrsoNet pose workload (``repro_torch.{pose,models.cnn,
data.pipeline,optim.adamw}``) against the reference's, at the size of
``tests/test_pose_qat.py`` (48 x 64 images, widths (8, 16), one block a
stage, fc 32) on the reference's weights (``ursonet_init(PRNGKey(0))``
through ``bridge.to_torch``).

The reference runs jitted in a subprocess with XLA's excess precision off,
so both sides round every bf16 op as written (``test_torch_model.py``).
A bf16 conv sums its products in f32 on both sides and agrees bit for bit
here, but GroupNorm's f32 mean and variance sum in another order than
XLA's, which moves a bf16 output by an ulp here and there, and through an
int8 segment such a move can flip an activation code.  So a bf16 conv is
held within 2 bf16 ulps of its largest magnitude with at least 95% of
elements identical; the network's features, loc and quat within
``2**-6 |ref| + 2**-8`` (f32 everywhere: 1e-5; int8 heads stage by stage,
see ``test_ursonet_apply_equals_the_reference``); gradients within 2e-2 of
the global norm and of each leaf's L2 norm (fake-quant training: 5e-2 of
the leaf, the reference's own spread; f32: rtol 1e-4, atol 1e-6 per
element); and five training steps' losses within 2e-2 relative (f32:
1e-4).

Data, keys and AdamW are f32 and run in this process: ``loc`` and the
keys are bit-equal; ``normal`` and so ``quat`` within 4 ulps (``erf_inv``'s
``log1p``); images within 2**-19 absolute (``exp`` and the einsums);
AdamW steps from the jitted reference's state within 1e-6 relative (XLA
fuses multiply-adds and folds divisions by constants; where the clip
bites, with a floor of 1e-6 of the leaf's largest magnitude).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import prng
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import pipeline as tpipe
from repro_torch.models import cnn as tcnn
from repro_torch.optim import adamw as tadamw
from repro_torch import pose as tpose

ROOT = Path(__file__).resolve().parents[1]
CFG = tcnn.UrsoNetConfig(name="test", image_hw=(48, 64), widths=(8, 16),
                         blocks_per_stage=1, fc_dim=32)
B = 4                       # forward and gradient batch
TRAIN_B, TRAIN_STEPS = 8, 5
TC = dict(learning_rate=3e-3, warmup_steps=10, total_steps=200,
          weight_decay=0.0, grad_clip=1.0)
# (k, stride, (H, W)) for pconv: every kernel and stride on an even and an
# odd size (SAME pads (k-1)//2 before and the rest after; stride 2 on an
# even size puts the extra pad after)
PCONV_CASES = [(k, s, hw) for k in (1, 3, 7) for s in (1, 2)
               for hw in ((10, 12), (9, 11))]
PCONV_MODES = ("fp32", "bf16", "fake", "quant")
GN_CASES = ((16, "float32"), (16, "bfloat16"), (12, "bfloat16"),
            (3, "float32"))
# policy pairs of the forward: each Table I condition's train and serve
# pair, and f32 everywhere
PAIRS = ["f32"] + [f"{c}/{ph}" for c in tpose.POLICIES
                   for ph in ("train", "serve")]
GRAD_PAIRS = ("f32", "fp32/train", "int8_qat/train", "mpai/train")
STEP_PAIRS = ("f32", "fp32/train", "int8_qat/train", "mpai/train")


def _pair(policy_cls, name):
    if name == "f32":
        return policy_cls.fp32(), policy_cls.fp32()
    cond, phase = name.split("/")
    pols = {"fp32": (policy_cls.bf16(), policy_cls.fp32(),
                     policy_cls.bf16(), policy_cls.fp32()),
            "int8_ptq": (policy_cls.bf16(), policy_cls.fp32(),
                         policy_cls.int8(), policy_cls.int8()),
            "int8_qat": (policy_cls.int8_qat(), policy_cls.int8_qat(),
                         policy_cls.int8(), policy_cls.int8()),
            "mpai": (policy_cls.int8_qat(), policy_cls.bf16(),
                     policy_cls.int8(), policy_cls.bf16())}[cond]
    return pols[:2] if phase == "train" else pols[2:]


def _mode_policy(policy_cls, mode):
    return {"fp32": policy_cls.fp32(), "bf16": policy_cls.bf16(),
            "fake": policy_cls.int8_qat(), "quant": policy_cls.int8()}[mode]


def _flat(tree, prefix=""):
    """{"a/0/b": leaf} of a tree of dicts and lists (numpy or torch)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _pconv_x(k, s, hw):
    cin = 3 if k == 7 else 5
    return np.random.default_rng(100 * k + 10 * s + hw[0]).normal(
        size=(2, *hw, cin)).astype(np.float32)


def _pconv_w(k, s, hw):
    cin = 3 if k == 7 else 5
    return (np.random.default_rng(7 + k + s + hw[1]).normal(
        size=(k, k, cin, 8)) / np.sqrt(k * k * cin)).astype(np.float32)


def _gn_x(c, dtype):
    return (np.random.default_rng(c).normal(size=(2, 6, 5, c)) * 3 + 1
            ).astype(np.float32)


def _gn_params(c):
    rng = np.random.default_rng(c + 1)
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(size=c).astype(np.float32)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread: the suite runs files in parallel
    workers, and a training loop on every core of a shared machine stalls
    them all."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NUDGE = 0.01                # one pixel of one image, for the conditioning


def _nudged(images):
    images = np.array(images)
    images[0, 10, 10, 0] += NUDGE
    return images


def _features(cnn_mod, apply, feat=None):
    """``apply()`` (an ``ursonet_apply`` call) with ``cnn_mod.pdot``
    watched: returns its (loc, quat) and the pooled backbone features that
    reach the first FC product, which are replaced by ``feat`` when it is
    given (the heads alone, on another backbone's features)."""
    orig, seen = cnn_mod.pdot, []

    def pdot(x, w, policy):
        if not seen and feat is not None:
            x = feat
        seen.append(x)
        return orig(x, w, policy)

    cnn_mod.pdot = pdot
    try:
        loc, q = apply()
    finally:
        cnn_mod.pdot = orig
    return loc, q, seen[0]


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_pose.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.core.precision import PrecisionPolicy
    from repro.data.pipeline import pose_batch
    from repro.models import cnn
    from repro.optim import adamw

    cfg = cnn.UrsoNetConfig(**CFG._asdict())
    res = {}
    for k, s, hw in PCONV_CASES:
        x, w = jnp.asarray(_pconv_x(k, s, hw)), jnp.asarray(_pconv_w(k, s, hw))
        for mode in PCONV_MODES:
            pol = _mode_policy(PrecisionPolicy, mode)
            xin = x if mode == "fp32" else x.astype(jnp.bfloat16)
            out = jax.jit(lambda a, b: cnn.pconv(a, b, s, pol))(xin, w)
            res[f"pconv/{k}/{s}/{hw[0]}/{mode}"] = np.asarray(
                out.astype(jnp.float32))
    for c, dtype in GN_CASES:
        x = jnp.asarray(_gn_x(c, dtype)).astype(dtype)
        p = jax.tree.map(jnp.asarray, _gn_params(c))
        res[f"gn/{c}/{dtype}"] = np.asarray(
            jax.jit(cnn.group_norm)(p, x).astype(jnp.float32))

    params = cnn.ursonet_init(jax.random.PRNGKey(0), cnn.UrsoNetConfig(
        **CFG._asdict()))
    b = pose_batch(B, 0, image_hw=cfg.image_hw)
    for name in PAIRS:
        bp, hp = _pair(PrecisionPolicy, name)
        loc, q, feat = jax.jit(lambda p, im: _features(
            cnn, lambda: cnn.ursonet_apply(p, cfg, im, bp, hp)))(
            params, b["images"])
        res[f"fwd/{name}/loc"], res[f"fwd/{name}/quat"] = (np.asarray(loc),
                                                           np.asarray(q))
        res[f"fwd/{name}/feat"] = np.asarray(feat.astype(jnp.float32))
        res[f"fwd/{name}/loss"] = np.asarray(jax.jit(cnn.pose_loss)(
            loc, q, b["loc"], b["quat"]))
        res[f"fwd/{name}/metrics"] = np.asarray(
            cnn.pose_metrics(loc, q, b["loc"], b["quat"]))

        # the reference's own conditioning: one pixel moved by NUDGE
        loc2, q2 = jax.jit(lambda p, im: cnn.ursonet_apply(
            p, cfg, im, bp, hp))(params, _nudged(b["images"]))
        res[f"nudge/{name}/loc"], res[f"nudge/{name}/quat"] = (
            np.asarray(loc2), np.asarray(q2))

    def loss_fn(p, images, loc, quat, bp, hp):
        pl, pq = cnn.ursonet_apply(p, cfg, images, bp, hp)
        return cnn.pose_loss(pl, pq, loc, quat)

    for name in GRAD_PAIRS:
        bp, hp = _pair(PrecisionPolicy, name)
        for tag, images in (("grad", b["images"]),
                            ("nudge_grad", _nudged(b["images"]))):
            g = jax.jit(jax.grad(lambda p: loss_fn(p, images, b["loc"],
                                                   b["quat"], bp, hp)))(params)
            for key, leaf in _flat(jax.tree.map(np.asarray, g)).items():
                res[f"{tag}/{name}/{key}"] = leaf

    tc = TrainConfig(**TC)
    for name in STEP_PAIRS:
        bp, hp = _pair(PrecisionPolicy, name)

        @jax.jit
        def step(p, opt, images, loc, quat):
            l, g = jax.value_and_grad(loss_fn)(p, images, loc, quat, bp, hp)
            p, opt, _ = adamw.apply_updates(p, g, opt, tc)
            return p, opt, l

        p, opt, losses = params, adamw.init(params), []
        for s in range(TRAIN_STEPS):
            tb = pose_batch(TRAIN_B, s, image_hw=cfg.image_hw)
            p, opt, l = step(p, opt, tb["images"], tb["loc"], tb["quat"])
            losses.append(float(l))
        res[f"steps/{name}"] = np.asarray(losses)
    for s in range(TRAIN_STEPS):
        tb = pose_batch(TRAIN_B, s, image_hw=cfg.image_hw)
        for key in ("images", "loc", "quat"):
            res[f"batch/{s}/{key}"] = np.asarray(tb[key])
    for key in ("images", "loc", "quat"):
        res[f"fwd_batch/{key}"] = np.asarray(b[key])
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("pose_ref") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                            os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
               PYTHONPATH=path)
    res = subprocess.run([sys.executable, __file__, str(out)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def params():
    """The reference's weights on the port (f32: the same in any process)."""
    import jax
    from repro.models import cnn
    jcfg = cnn.UrsoNetConfig(**CFG._asdict())
    return bridge.to_torch(jax.tree.map(
        np.asarray, cnn.ursonet_init(jax.random.PRNGKey(0), jcfg)), "cpu")


def _assert_within_bf16_ulps(got, want, ulps=2, identical=0.95):
    """|got - want| <= ``ulps`` bf16 ulps of max|want|, and at least
    ``identical`` of the elements equal."""
    got, want = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulps * ulp, (
        np.abs(got - want).max(), ulp)
    assert (got == want).mean() >= identical, (got == want).mean()


def _ulps(got, want):
    """Distance in float32 ulps (sign-magnitude order)."""
    def order(a):
        i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(order(got) - order(want))


# ---------------------------------------------------------------------------
# network pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", PCONV_MODES)
@pytest.mark.parametrize("k,s,hw", PCONV_CASES,
                         ids=[f"k{k}s{s}_{hw[0]}x{hw[1]}"
                              for k, s, hw in PCONV_CASES])
def test_pconv_equals_the_reference(ref, k, s, hw, mode):
    x = torch.from_numpy(_pconv_x(k, s, hw))
    if mode != "fp32":
        x = x.bfloat16()
    out = tcnn.pconv(x, torch.from_numpy(_pconv_w(k, s, hw)), s,
                     _mode_policy(TPolicy, mode))
    want = ref[f"pconv/{k}/{s}/{hw[0]}/{mode}"]
    assert tuple(out.shape) == want.shape == (2, -(-hw[0] // s),
                                              -(-hw[1] // s), 8)
    if mode == "fp32":
        assert out.dtype == torch.float32
        np.testing.assert_allclose(_f32(out), want, rtol=1e-5, atol=1e-6)
    else:
        assert out.dtype == torch.bfloat16
        _assert_within_bf16_ulps(out, want)


@pytest.mark.parametrize("c,dtype", GN_CASES)
def test_group_norm_equals_the_reference(ref, c, dtype):
    x = torch.from_numpy(_gn_x(c, dtype)).to(getattr(torch, dtype))
    p = {k: torch.from_numpy(v) for k, v in _gn_params(c).items()}
    out = tcnn.group_norm(p, x)
    assert out.dtype == x.dtype
    want = ref[f"gn/{c}/{dtype}"]
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), want, rtol=1e-5, atol=1e-5)
    else:
        _assert_within_bf16_ulps(out, want, ulps=1)


def test_same_padding_is_asymmetric_under_stride_two():
    # the stem: k 7, s 2 on 192 x 256 pads (2, 3); a 3x3 stride-2 conv on
    # an even size pads (0, 1); stride 1 pads evenly
    assert tcnn._same_pads(192, 7, 2) == (2, 3)
    assert tcnn._same_pads(256, 7, 2) == (2, 3)
    assert tcnn._same_pads(48, 3, 2) == (0, 1)
    assert tcnn._same_pads(9, 3, 2) == (1, 1)
    assert tcnn._same_pads(10, 3, 1) == (1, 1)
    assert tcnn._same_pads(10, 1, 1) == (0, 0)


def _int8_head(name):
    return name != "f32" and _pair(TPolicy, name)[1].precision.is_quantized


@pytest.mark.parametrize("name", PAIRS)
def test_ursonet_apply_equals_the_reference(ref, params, name):
    """The backbone's pooled features, the heads on the reference's
    features, and (where the heads keep float activations) the whole
    network.  An int8 head quantizes its activations per tensor across
    the batch, so one flipped bf16 ulp in a GroupNorm output (XLA and
    torch sum its mean and variance in other orders) can move a code and
    the quat by more than the tolerance: the reference itself moves quat
    by up to 4.2x the tolerance when one pixel of one image moves by 0.01
    (int8_qat train pair; 1.3-3.5x for the others).  Those pairs are held
    stage by stage."""
    images = torch.from_numpy(ref["fwd_batch/images"])
    pair = _pair(TPolicy, name)
    tol = (dict(rtol=1e-5, atol=1e-5) if name == "f32"
           else dict(rtol=2 ** -6, atol=2 ** -8))
    loc, q, feat = _features(tcnn, lambda: tcnn.ursonet_apply(
        params, CFG, images, *pair))
    assert loc.dtype == q.dtype == torch.float32
    assert tuple(loc.shape) == (B, 3) and tuple(q.shape) == (B, 4)
    assert feat.dtype == (torch.float32 if name == "f32" else torch.bfloat16)
    want_feat = ref[f"fwd/{name}/feat"]
    np.testing.assert_allclose(_f32(feat), want_feat, **tol)
    on_ref = _features(tcnn, lambda: tcnn.ursonet_apply(
        params, CFG, images, *pair), torch.from_numpy(want_feat).to(
            feat.dtype))
    whole = (loc, q) if not _int8_head(name) else None
    for i, key in enumerate(("loc", "quat")):
        want = ref[f"fwd/{name}/{key}"]
        np.testing.assert_allclose(_f32(on_ref[i]), want, **tol)
        if whole is not None:
            np.testing.assert_allclose(_f32(whole[i]), want, **tol)


def test_int8_heads_amplify_one_nudged_pixel_past_the_tolerance(ref):
    """Why the int8-head pairs are held stage by stage: the reference's own
    loc or quat moves past ``2**-6 |ref| + 2**-8`` when one pixel of one
    image moves by ``NUDGE``, while the float heads stay inside it."""
    def moved(name):
        return max(np.max(np.abs(ref[f"nudge/{name}/{k}"]
                                  - ref[f"fwd/{name}/{k}"])
                          / (2 ** -6 * np.abs(ref[f"fwd/{name}/{k}"])
                             + 2 ** -8)) for k in ("loc", "quat"))
    assert moved("int8_qat/train") > 1.0
    assert max(moved(n) for n in PAIRS if _int8_head(n)) > 2.0
    assert moved("f32") < 1.0


@pytest.mark.parametrize("name", ("int8_qat/train", "mpai/train"))
def test_fake_quant_gradients_move_past_the_leaf_bound_under_a_nudge(ref,
                                                                     name):
    """Why fake-quant training is held to 5e-2 of a leaf's L2 norm, not
    2e-2: the reference's own gradient moves by more than 5e-2 in some leaf
    when one pixel moves by ``NUDGE``."""
    worst = max(np.linalg.norm(ref[f"nudge_grad/{name}/{k[len(f'grad/{name}/'):]}"]
                               - ref[k]) / np.linalg.norm(ref[k])
                for k in ref if k.startswith(f"grad/{name}/"))
    assert worst > 5e-2, worst


@pytest.mark.parametrize("name", PAIRS)
def test_pose_loss_and_metrics_equal_the_reference(ref, name):
    """On the reference's own outputs, so only the loss and metric
    arithmetic is compared."""
    args = [torch.from_numpy(ref[k]) for k in
            (f"fwd/{name}/loc", f"fwd/{name}/quat", "fwd_batch/loc",
             "fwd_batch/quat")]
    np.testing.assert_allclose(_f32(tcnn.pose_loss(*args)),
                               ref[f"fwd/{name}/loss"], rtol=1e-6)
    loce, orie = tcnn.pose_metrics(*args)
    np.testing.assert_allclose([float(loce), float(orie)],
                               ref[f"fwd/{name}/metrics"], rtol=1e-5)


def test_port_init_builds_the_reference_tree():
    import jax
    from repro.models import cnn
    jcfg = cnn.UrsoNetConfig(**tcnn.UrsoNetConfig()._asdict())
    want = _flat(jax.eval_shape(lambda k: cnn.ursonet_init(k, jcfg),
                                jax.random.PRNGKey(0)))
    got = _flat(tcnn.ursonet_init(torch.Generator().manual_seed(0),
                                  tcnn.UrsoNetConfig(), "cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32


def test_layer_tables_equal_the_reference():
    from repro.models import cnn
    for fn in ("mobilenet_v2_layers", "resnet50_layers",
               "inception_v4_layers", "ursonet_table1_layers"):
        assert [tuple(l) for l in getattr(tcnn, fn)()] == \
            [tuple(l) for l in getattr(cnn, fn)()], fn
    for cfg in (tcnn.UrsoNetConfig(), CFG):
        jcfg = cnn.UrsoNetConfig(**cfg._asdict())
        assert [tuple(l) for l in tcnn.ursonet_layers(cfg)] == \
            [tuple(l) for l in cnn.ursonet_layers(jcfg)]


def test_configs_equal_the_reference():
    from repro.configs import ursonet as jcfgs
    from repro_torch.configs import ursonet as tcfgs
    from repro.configs.base import TrainConfig as JTrain
    for name in ("FULL", "SMOKE"):
        assert tuple(getattr(tcfgs, name)) == tuple(getattr(jcfgs, name))
    assert TTrain().__dict__ == JTrain().__dict__


# ---------------------------------------------------------------------------
# gradients and training
# ---------------------------------------------------------------------------
def _port_grads(params, ref, name):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    pl, pq = tcnn.ursonet_apply(p, CFG, torch.from_numpy(
        ref["fwd_batch/images"]), *_pair(TPolicy, name))
    tcnn.pose_loss(pl, pq, torch.from_numpy(ref["fwd_batch/loc"]),
                   torch.from_numpy(ref["fwd_batch/quat"])).backward()
    return {k: v.grad for k, v in _flat(p).items()}


@pytest.mark.parametrize("name", GRAD_PAIRS)
def test_gradients_equal_jax_grad(ref, params, name):
    got = _port_grads(params, ref, name)
    want = {k[len(f"grad/{name}/"):]: v for k, v in ref.items()
            if k.startswith(f"grad/{name}/")}
    assert sorted(got) == sorted(want)
    if name == "f32":
        for k in want:
            np.testing.assert_allclose(_f32(got[k]), want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        return
    norm = lambda g: np.sqrt(sum(float(np.sum(np.square(_f32(v))))
                                 for v in g.values()))
    np.testing.assert_allclose(norm(got), norm(want), rtol=2e-2)
    # per leaf, the relative L2 error: bf16 rounding alone (fp32/train)
    # stays within 2e-2; with fake quantization one flipped activation code
    # moves whole leaves, and the reference's own gradient moves up to
    # 7.4% (int8_qat) and 7.0% (mpai) when one pixel moves by 0.01
    bound = 2e-2 if name == "fp32/train" else 5e-2
    for k in want:
        g, w = _f32(got[k]), want[k]
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= bound, (k, err)


@pytest.mark.parametrize("name", STEP_PAIRS)
def test_train_step_losses_equal_the_reference_loop(ref, params, name):
    tc = TTrain(**TC)
    p, opt, losses = params, tadamw.init(params), []
    for s in range(TRAIN_STEPS):
        batch = [torch.from_numpy(ref[f"batch/{s}/{k}"])
                 for k in ("images", "loc", "quat")]
        p, opt, loss = tpose.train_step(p, opt, *batch, CFG,
                                        _pair(TPolicy, name), tc)
        losses.append(float(loss))
    assert int(opt.count) == TRAIN_STEPS
    np.testing.assert_allclose(losses, ref[f"steps/{name}"],
                               rtol=1e-4 if name == "f32" else 2e-2)


# ---------------------------------------------------------------------------
# keys, data and AdamW (f32, in this process)
# ---------------------------------------------------------------------------
SEEDS = (0, 1, 7919, -3, 2**31 - 1)
NORMAL_ULPS = 4
QUAT_ULPS = 4
IMAGE_ATOL = 2.0 ** -19


def _jkey(seed):
    import jax
    return jax.random.PRNGKey(np.int32(seed))


def _tkey(seed):
    return prng.threefry_seed(torch.tensor(seed))


@pytest.mark.parametrize("num", (2, 3, 64))
@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed, num):
    import jax
    want = np.asarray(jax.random.split(_jkey(seed), num)).astype(np.int64)
    got = prng.split(_tkey(seed), num)
    np.testing.assert_array_equal(got.numpy(), want)
    # a batch of keys splits each
    two = torch.stack([_tkey(seed), _tkey(seed + 1)])
    np.testing.assert_array_equal(prng.split(two, num)[0].numpy(), want)


@pytest.mark.parametrize("bounds", ((-3.0, 3.0), (-2.0, 2.0), (8.0, 24.0)))
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_with_bounds_equals_jax(seed, bounds):
    """XLA fuses the scale and shift of a uniform into one fma: without it,
    17% of draws on (-3, 3) land an ulp off."""
    import jax
    want = np.asarray(jax.random.uniform(_jkey(seed), (4096,),
                                         minval=bounds[0], maxval=bounds[1]))
    got = prng.uniform(_tkey(seed), (4096,), *bounds)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps_of_jax(seed):
    import jax
    want = np.asarray(jax.random.normal(_jkey(seed), (64, 100)))
    got = prng.normal(_tkey(seed), (64, 100)).numpy()
    d = _ulps(got, want)
    assert d.max() <= NORMAL_ULPS, d.max()
    assert (d > 0).mean() <= 0.02, (d > 0).mean()


def test_erf_inv_within_ulps_of_xla():
    import jax
    import jax.numpy as jnp
    x = np.linspace(-1, 1, 20001, dtype=np.float32)
    x[x == 0] = 1e-30
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[-1])
    finite = np.isfinite(want)
    assert _ulps(got[finite], want[finite]).max() <= 3
    # torch's own erfinv is another approximation
    assert _ulps(torch.erfinv(torch.from_numpy(x)).numpy()[finite],
                 want[finite]).max() > 3


@pytest.mark.parametrize("step,seed,hw", [(0, 0, (48, 64)), (7, 0, (48, 64)),
                                          (10_000, 1000, (48, 64)),
                                          (3, 5, (192, 256))])
def test_pose_batch_equals_the_reference(step, seed, hw):
    from repro.data.pipeline import pose_batch
    want = pose_batch(16, step, seed=seed, image_hw=hw)
    got = tpipe.pose_batch(16, step, seed=seed, image_hw=hw, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "images": (16, *hw, 3), "loc": (16, 3), "quat": (16, 4)}
    assert all(v.dtype == torch.float32 for v in got.values())
    np.testing.assert_array_equal(got["loc"].numpy(), np.asarray(want["loc"]))
    assert _ulps(got["quat"].numpy(), np.asarray(want["quat"])).max() \
        <= QUAT_ULPS
    np.testing.assert_allclose(got["images"].numpy(),
                               np.asarray(want["images"]), rtol=0,
                               atol=IMAGE_ATOL)


def test_tree_leaves_in_jax_order():
    import jax
    tree = {"b": [np.zeros(1), {"z": np.ones(2), "a": np.full(3, 2.0)}],
            "a": np.full(4, 3.0), "c": None}
    want = [a.tolist() for a in jax.tree_util.tree_leaves(tree)]
    got = [t.tolist() for t in tree_leaves(tree_map(torch.tensor, tree))]
    assert got == want


def _adamw_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "blocks": [{"k": rng.normal(size=(3, 3, 2, 4)).astype(
                  np.float32), "b": rng.normal(size=(4,)).astype(np.float32)}],
              "a": rng.normal(size=(7,)).astype(np.float32)}
    grads = [tree_map(lambda x: (rng.normal(size=x.shape)
                                 * rng.uniform(0.05, 2)).astype(np.float32),
                      params) for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("clip", (1.0, 1e6))
@pytest.mark.parametrize("wd", (0.0, 0.1))
def test_adamw_steps_equal_the_reference(wd, clip):
    """Five steps, each from the reference's own state, within 1e-6
    relative.  The global norm sums each leaf in XLA's order, which can
    differ from torch's by an ulp; where the clip bites (``clip`` 1.0) that
    ulp scales every gradient, and a moment that cancels (``b1 * m`` against
    ``(1 - b1) * g``) carries it as up to 1e-5 of its own size, so there the
    floor is 1e-6 of the leaf's largest magnitude.  With the clip off the
    scale is exactly 1 and no floor is taken."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.optim import adamw
    kw = dict(TC, weight_decay=wd, warmup_steps=2, grad_clip=clip)
    tcj, tct = TrainConfig(**kw), TTrain(**kw)
    params, grads = _adamw_trees(int(wd * 10))
    pj = jax.tree.map(jnp.asarray, params)
    sj = adamw.init(pj)
    step = jax.jit(lambda p, g, s: adamw.apply_updates(p, g, s, tcj))
    to_t = lambda tree: tree_map(lambda a: torch.tensor(np.asarray(a)), tree)
    for g in grads:
        pt, st, gnt = tadamw.apply_updates(
            to_t(pj), to_t(g), tadamw.AdamWState(
                to_t(sj.mu), to_t(sj.nu), torch.tensor(int(sj.count),
                                                       dtype=torch.int32)),
            tct)
        pj, sj, gnj = step(pj, jax.tree.map(jnp.asarray, g), sj)
        np.testing.assert_allclose(float(gnt), float(gnj), rtol=1e-6)
        assert int(st.count) == int(sj.count)
        for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
            got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
            assert sorted(got) == sorted(want)
            for k in want:
                floor = 1e-6 * np.abs(want[k]).max() if clip == 1.0 else 0
                np.testing.assert_allclose(got[k].numpy(), want[k],
                                           rtol=1e-6, atol=floor, err_msg=k)
    assert int(sj.count) == 5


def test_cosine_lr_and_clip_equal_the_reference():
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig
    from repro.optim import adamw
    steps = np.arange(0, 230, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: adamw.cosine_lr(
        TrainConfig(**TC), s))(jnp.asarray(steps)))
    got = tadamw.cosine_lr(TTrain(**TC), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and got[10] == np.float32(TC["learning_rate"])
    assert got[-1] == 0.0
    params, grads = _adamw_trees(3)
    for max_norm in (1.0, 1e3):
        cj, nj = jax.jit(lambda g: adamw.clip_by_global_norm(g, max_norm))(
            jax.tree.map(jnp.asarray, grads[0]))
        ct, nt = tadamw.clip_by_global_norm(tree_map(torch.tensor, grads[0]),
                                            max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
        for k, w in _flat(jax.tree.map(np.asarray, cj)).items():
            np.testing.assert_allclose(_flat(ct)[k].numpy(), w, rtol=1e-6)


if __name__ == "__main__":
    _reference(sys.argv[1])
