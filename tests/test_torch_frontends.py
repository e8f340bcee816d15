"""The modality frontends on the port (``models/frontends.py``) and the
frontend prefix of ``transformer.forward`` / ``prefill`` / ``loss_fn``,
against the reference on the ``musicgen-medium`` (audio) and
``llava-next-mistral-7b`` (vision) smoke configs; the train launcher on
the CPU.

The reference runs jitted in a subprocess with XLA's excess precision off
(``test_torch_model.py``): logits within one bf16 ulp of their largest
magnitude (two for musicgen under "mpai", ``ULPS``) and at least 95%
identical, the f32 loss over bf16 logits within 2 bf16 ulps
(``test_torch_qat.py``).  ``synthetic_frontend_embeds`` goes
through ``prng.normal`` (1% of draws within 3 f32 ulps of jax's) and a
bf16 cast: within one bf16 ulp.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.models import frontends as tfe
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("musicgen-medium", "llava-next-mistral-7b")
PLANS = ("bf16", "mpai")
B, S = 2, 8
EMBED_CASES = [(a, b, seed) for a in ARCHS for b, seed in ((1, 0), (3, 5))]


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_frontends.py OUT.npz``
# ---------------------------------------------------------------------------
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.models import transformer as T
    from repro.models.frontends import synthetic_frontend_embeds

    res = {}
    for arch, batch, seed in EMBED_CASES:
        fe = synthetic_frontend_embeds(jget(arch, smoke=True), batch,
                                       seed=seed)
        res[f"embeds/{arch}/{batch}/{seed}"] = np.asarray(
            fe.astype(jnp.float32))
    for arch in ARCHS:
        cfg = jget(arch, smoke=True)
        params = T.model_init(jax.random.PRNGKey(1), cfg)
        _flatten(params, f"{arch}/params", res)
        fe = synthetic_frontend_embeds(cfg, B, seed=3)
        toks, labels = jnp.asarray(_tokens(cfg, 0)), jnp.asarray(
            _tokens(cfg, 1))
        for pname in PLANS:
            plan = (qat.train_plan(PartitionPlan.mpai(cfg.num_layers))
                    if pname == "mpai" else None)
            logits = jax.jit(lambda p, f: T.forward(
                p, cfg, toks, plan, frontend_embeds=f).logits)(params, fe)
            res[f"{arch}/{pname}/logits"] = np.asarray(
                logits.astype(jnp.float32))
            res[f"{arch}/{pname}/loss"] = np.asarray(jax.jit(
                lambda p, f: T.loss_fn(p, cfg, toks, labels, plan,
                                       frontend_embeds=f))(params, fe))
        cache = T.init_cache(cfg, B, S + cfg.frontend_tokens + 4)
        out = jax.jit(lambda p, c, f: T.prefill(p, cfg, toks, c,
                                                frontend_embeds=f))(
            params, cache, fe)
        res[f"{arch}/prefill/logits"] = np.asarray(
            out.logits.astype(jnp.float32))
        res[f"{arch}/prefill/k0"] = np.asarray(
            out.cache["sub_0"].k.astype(jnp.float32))
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("frontends_ref") / "ref.npz"
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


def _setup(ref, arch):
    cfg = get_config(arch, smoke=True)
    params = bridge.to_torch(_unflatten(ref, f"{arch}/params"), "cpu")
    fe = tfe.synthetic_frontend_embeds(cfg, B, seed=3, device="cpu")
    return cfg, params, fe


def _plan(cfg, pname):
    return (tqat.train_plan(TPlan.mpai(cfg.num_layers))
            if pname == "mpai" else None)


def _assert_logits(got, want, ulps=1):
    got = _f32(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ulps * _bf16_ulp(want)
    assert (got == want).mean() >= 0.95, (got == want).mean()


# musicgen's GeLU MLP (``layers.gelu`` is bit-equal to ``jax.nn.gelu`` in
# bf16) passes the attention's one-ulp moves on with a steeper slope than
# SwiGLU: under "mpai", where such a move can flip an int8 activation code,
# its logits are within 2 bf16 ulps (measured 2.0, 97% identical), and the
# second layer's cached k within 1.5 (98% identical); layer 0's k is exact
ULPS = {("musicgen-medium", "mpai"): 2}


# ---------------------------------------------------------------------------
# the stubs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,batch,seed", EMBED_CASES,
                         ids=[f"{a}-b{b}-s{s}" for a, b, s in EMBED_CASES])
def test_synthetic_embeds_within_one_bf16_ulp(ref, arch, batch, seed):
    cfg = get_config(arch, smoke=True)
    got = tfe.synthetic_frontend_embeds(cfg, batch, seed=seed, device="cpu")
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == tfe.frontend_embed_shape(cfg, batch) == \
        (batch, cfg.frontend_tokens, cfg.d_model)
    want = ref[f"embeds/{arch}/{batch}/{seed}"]
    np.testing.assert_allclose(_f32(got), want, rtol=2 ** -8, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_shape_and_spec_equal_the_reference(arch):
    from repro.configs import get_config as jget
    from repro.models import frontends as jfe
    jcfg, cfg = jget(arch), get_config(arch)
    for dtype, jdtype in ((torch.bfloat16, "bfloat16"),
                          (torch.float32, "float32")):
        spec = tfe.frontend_embeds_spec(cfg, 4, dtype)
        want = jfe.frontend_embeds_spec(jcfg, 4, jdtype)
        assert spec.device.type == "meta" and spec.dtype == dtype
        assert tuple(spec.shape) == tuple(want.shape)
    assert tfe.frontend_embed_shape(cfg, 2) == \
        jfe.frontend_embed_shape(jcfg, 2)


# ---------------------------------------------------------------------------
# the model with a frontend prefix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_frontend_embeds_equals_the_reference(ref, arch, pname):
    cfg, params, fe = _setup(ref, arch)
    toks = torch.from_numpy(_tokens(cfg, 0))
    with torch.no_grad():
        out = TT.forward(params, cfg, toks, _plan(cfg, pname),
                         frontend_embeds=fe)
    assert out.logits.shape == (B, cfg.frontend_tokens + S, cfg.vocab_size)
    _assert_logits(out.logits, ref[f"{arch}/{pname}/logits"],
                   ULPS.get((arch, pname), 1))


@pytest.mark.parametrize("pname", PLANS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_skips_the_frontend_positions(ref, arch, pname):
    cfg, params, fe = _setup(ref, arch)
    toks, labels = (torch.from_numpy(_tokens(cfg, s)) for s in (0, 1))
    plan = _plan(cfg, pname)
    with torch.no_grad():
        loss = TT.loss_fn(params, cfg, toks, labels, plan,
                          frontend_embeds=fe)
        logits = TT.forward(params, cfg, toks, plan,
                            frontend_embeds=fe).logits
    want = float(ref[f"{arch}/{pname}/loss"])
    assert abs(float(loss) - want) <= 2 * _bf16_ulp(want)
    # the loss is the cross-entropy of the token positions alone
    from repro_torch.models.layers import cross_entropy
    assert torch.equal(loss, cross_entropy(logits[:, -S:], labels))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_frontend_embeds_equals_the_reference(ref, arch):
    cfg, params, fe = _setup(ref, arch)
    toks = torch.from_numpy(_tokens(cfg, 0))
    cache = TT.init_cache(cfg, B, S + cfg.frontend_tokens + 4, device="cpu")
    with torch.no_grad():
        out = TT.prefill(params, cfg, toks, cache, frontend_embeds=fe)
    _assert_logits(out.logits, ref[f"{arch}/prefill/logits"])
    # the frontend positions are in the cache, before the tokens'
    assert int(out.cache["sub_0"].pos[0]) == cfg.frontend_tokens + S
    k, want = _f32(out.cache["sub_0"].k), ref[f"{arch}/prefill/k0"]
    np.testing.assert_array_equal(k[0], want[0])
    _assert_logits(k, want, ulps=2)


def test_frontend_embeds_get_gradients():
    """A frontend's embeddings are a differentiable input (the vision or
    audio tower upstream trains through them)."""
    cfg = get_config("llava-next-mistral-7b", smoke=True)
    params = TT.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    fe = tfe.synthetic_frontend_embeds(cfg, B, device="cpu").float()
    fe.requires_grad_(True)
    toks, labels = (torch.from_numpy(_tokens(cfg, s)) for s in (2, 3))
    TT.loss_fn(params, cfg, toks, labels, frontend_embeds=fe).backward()
    assert fe.grad is not None and fe.grad.shape == fe.shape
    assert torch.isfinite(fe.grad).all() and fe.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--arch", "musicgen-medium", "--smoke", "--steps", "2"],
    ["--arch", "llava-next-mistral-7b", "--smoke", "--steps", "3",
     "--plan", "mpai", "--ckpt-every", "2"],
    ["--arch", "stablelm-1.6b", "--smoke", "--shape", "32x2", "--steps",
     "2"]], ids=["musicgen", "llava-mpai", "stablelm"])
def test_train_launcher_runs_on_the_cpu(argv, tmp_path, capsys):
    from repro_torch.launch import train
    out = train.main(argv + ["--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    steps = int(argv[argv.index("--steps") + 1])
    assert [h["step"] for h in out["history"]] == list(range(1, steps + 1))
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    text = capsys.readouterr().out
    assert text.count("step ") == steps and "device=cpu" in text
    assert sorted(os.listdir(tmp_path))[0] == "step_00000000"


@pytest.mark.parametrize("mesh", ("single_pod", "multi_pod"))
def test_train_launcher_refuses_pod_meshes(mesh):
    """A pod mesh needs its 256 / 512 ranks; with no process group the
    world is one device (the reference's ``make_mesh_from_config``
    message)."""
    from repro_torch.launch import train
    n = 512 if mesh == "multi_pod" else 256
    with pytest.raises(ValueError, match=f"need {n} devices, have 1"):
        train.main(["--arch", "stablelm-1.6b", "--smoke", "--mesh", mesh,
                    "--device", "cpu"])


if __name__ == "__main__":
    _reference(sys.argv[1])
