"""Training the recurrent families on the port against the reference: the
plain backwards of the wkv recurrence and the selective scan (the CPU side
of ``csrc/wkv_bwd.cu`` and ``csrc/selective_scan_bwd.cu``) against
``jax.grad`` of the reference's oracles (``repro.kernels.ref.wkv_ref`` and
``selective_scan_ref``), the final state's gradient against torch autograd
of the plain forward (the oracles return no state), ``loss_fn`` gradients
of ``rwkv6-smoke`` and ``jamba-smoke`` under the f32, bf16 and ``"mpai"``
plans against ``jax.grad`` of the reference's ``T.loss_fn``, and three
``make_step_fn`` steps of ``rwkv6-smoke``, each from the reference's state
before it; and, on the card (``cuda``), each
backward kernel against its plain version, two backward runs bit-equal
(each kernel, and the MoE dispatch), and a bf16 step of each smoke config
equal to the CPU's.

The reference runs jitted in a subprocess with XLA's excess precision off
(``test_torch_train.py``).  Its recurrences differentiate XLA's associative
scan in chunks, the port's walk back sequentially from checkpoints, so the
two agree within f32 rounding (ROADMAP, "Known parity hazards").
Tolerances: each plain backward within 1e-4 of each gradient's L2 norm;
``loss_fn`` gradients within 1e-4 of each leaf's norm under f32 and
``LOW_TOL`` under bf16 and ``"mpai"``.  ``LOW_TOL`` is 3e-2, not
``test_torch_train.py``'s 2e-2: the RWKV-6 time mix adds some forty bf16
elementwise ops a layer (token shift, five LoRA mixes, decay, group norm),
whose backward rounds in another order under torch's autograd than under
XLA's transpose, and the small LoRA leaves then move most (2.1e-2 measured
at ``mu_x`` under ``"mpai"``).  Steps within ``STEP_TOL``, each started
from the reference's state (parameters and AdamW moments): run freely, a
first Adam step turns a near-zero gradient's sign into a +-lr move, and on
RWKV's 0.01-scale LoRA weights that moves the next step's gradient norm
past ``STEP_TOL`` under bf16 with no fault in either package.
Jamba's bf16 and ``"mpai"`` cases keep the MoE near-tie guard (ROADMAP,
"MoE routing"): where a token's k-th and (k+1)-th router probabilities lie
within ``MOE_TIE`` in the port, a one-ulp move upstream may route it to
other experts in the reference, so the gradients are held only through the
loss and the global gradient norm.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import jamba_v0_1_52b as tj
from repro_torch.configs import rwkv6_3b as tr
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import qat as tqat
from repro_torch.core.partition import PartitionPlan as TPlan
from repro_torch.core.precision import PrecisionPolicy as TPolicy
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import selective_scan as tss
from repro_torch.kernels import wkv as twkv
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import train_loop as ttrain

ROOT = Path(__file__).resolve().parents[1]
PLANS = ("f32", "bf16", "mpai")
CONFIGS = {"rwkv6-smoke": tr.SMOKE, "jamba-smoke": tj.SMOKE}
MODEL_CASES = [(c, p) for c in CONFIGS for p in PLANS]
B, S = 2, 24
TC_KW = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50,
             checkpoint_every=5, seed=0)
STEPS = 3
# (B, S, H, N, decay): the head sizes of the smoke config (16), of RWKV-6
# 3B (64) and the smallest compiled (8); one step and a ragged S; decays
# near 0 (exp(-exp(z + 2.5)) ~ 1e-5) and near 1 (exp(-exp(z - 6)) ~
# 0.998); S 70 crosses a checkpoint (every 64 steps)
WKV_CASES = ([(2, s, 2, n, dec) for n in (8, 16, 64) for s in (1, 37)
              for dec in ("near0", "near1")]
             + [(1, 70, 2, 8, "near1")])
# (B, S, D, N): D 100 at N 16 is not a multiple of the backward's 64
# channels a block (nor of the forward's), S 70 crosses a checkpoint
SCAN_CASES = [(2, 37, 100, 16), (1, 1, 5, 4), (2, 70, 33, 8)]
# router probabilities closer than this at the top-k boundary may route a
# token differently in the two packages (ROADMAP, "MoE routing": a flip
# seen at a margin of 5e-5)
MOE_TIE = 1e-4
# bf16 and "mpai" gradients, of each leaf's norm (module docstring)
LOW_TOL = 3e-2
# (loss rtol, grad-norm rtol, max |param diff|, mean |param diff|) of a
# step, as tests/test_torch_train.py holds tiny_dense
STEP_TOL = {"f32": (1e-6, 1e-5, 1e-3, 1e-6),
            "bf16": (2 ** -7, 5e-2, 2.2 * TC_KW["learning_rate"], 2e-3)}


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


def _wkv_inputs(b, s, h, n, decay):
    rng = np.random.default_rng(1000 * n + s)
    r, k, v, dy = (rng.normal(size=(b, s, h, n)).astype(np.float32)
                   for _ in range(4))
    z = rng.normal(size=(b, s, h, n))
    shift = 2.5 if decay == "near0" else -6.0
    w = np.exp(-np.exp(z + shift)).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    return r, k, v, w, u, dy


def _scan_inputs(b, s, dim, n):
    rng = np.random.default_rng(100 * n + s + dim)
    x, dy = (rng.normal(size=(b, s, dim)).astype(np.float32)
             for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(b, s, dim)) - 3)).astype(
        np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (dim, 1))
    d = rng.normal(size=(dim,)).astype(np.float32)
    return x, dt, bm, cm, a, d, dy


def _case_id(case):
    return "-".join(str(c) for c in case)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU work in one thread (ROADMAP.md, "Test budget")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference, run as ``python tests/test_torch_recurrent_train.py OUT``
# ---------------------------------------------------------------------------
def _ref_plan(pname, cfg):
    from repro.core import qat
    from repro.core.partition import PartitionPlan
    from repro.core.precision import PrecisionPolicy
    if pname == "f32":
        return PartitionPlan.uniform(cfg.num_layers, PrecisionPolicy.fp32())
    if pname == "mpai":
        return qat.train_plan(PartitionPlan.mpai(cfg.num_layers))
    return None


def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from repro.configs import jamba_v0_1_52b as jj
    from repro.configs import rwkv6_3b as jr
    from repro.configs.base import ShapeConfig, TrainConfig
    from repro.data.pipeline import lm_batch
    from repro.kernels import ref
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.runtime.train_loop import TrainState, make_step_fn

    res = {}
    for case in WKV_CASES:
        r, k, v, w, u, dy = map(jnp.asarray, _wkv_inputs(*case))
        grads = jax.jit(jax.grad(
            lambda *a: jnp.sum(ref.wkv_ref(*a) * dy),
            argnums=(0, 1, 2, 3, 4)))(r, k, v, w, u)
        for name, g in zip(("dr", "dk", "dv", "dw", "du"), grads):
            res[f"wkv/{_case_id(case)}/{name}"] = np.asarray(g)
    for case in SCAN_CASES:
        x, dt, bm, cm, a, d, dy = map(jnp.asarray, _scan_inputs(*case))
        grads = jax.jit(jax.grad(
            lambda *p: jnp.sum(ref.selective_scan_ref(*p) * dy),
            argnums=(0, 1, 2, 3, 4, 5)))(x, dt, bm, cm, a, d)
        for name, g in zip(("dx", "ddt", "db", "dc", "da", "dd"), grads):
            res[f"scan/{_case_id(case)}/{name}"] = np.asarray(g)

    shape = ShapeConfig("t", S, B, "train")
    tc = TrainConfig(**TC_KW)
    for name, cfg in (("rwkv6-smoke", jr.SMOKE), ("jamba-smoke", jj.SMOKE)):
        params = T.model_init(jax.random.PRNGKey(0), cfg)
        _flatten(params, f"{name}/params", res)
        batch = lm_batch(cfg, shape, 0)
        for pname in PLANS:
            plan = _ref_plan(pname, cfg)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: T.loss_fn(p, cfg, batch["tokens"], batch["labels"],
                                    plan)))(params)
            res[f"{name}/{pname}/loss"] = np.asarray(loss)
            _flatten(grads, f"{name}/{pname}/grad", res)
        if name != "rwkv6-smoke":
            continue
        for pname in STEP_TOL:
            step = jax.jit(make_step_fn(cfg, tc, _ref_plan(pname, cfg), 1))
            state = TrainState(params, adamw.init(params, jnp.float32),
                               jnp.zeros((), jnp.int32))
            for s in range(STEPS):
                _flatten({"params": state.params, "mu": state.opt.mu,
                          "nu": state.opt.nu}, f"step/{pname}/{s}", res)
                res[f"step/{pname}/{s}/count"] = np.asarray(state.opt.count)
                state, m = step(state, lm_batch(cfg, shape, s))
                res[f"step/{pname}/{s}/loss"] = np.asarray(m["loss"])
                res[f"step/{pname}/{s}/grad_norm"] = np.asarray(
                    m["grad_norm"])
            _flatten(state.params, f"step/{pname}/{STEPS}/params", res)
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("recurrent_train_ref") / "ref.npz"
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


def _port_plan(pname, cfg):
    if pname == "f32":
        return TPlan.uniform(cfg.num_layers, TPolicy.fp32())
    if pname == "mpai":
        return tqat.train_plan(TPlan.mpai(cfg.num_layers))
    return None


def _batch(cfg, step=0):
    return tpipe.lm_batch(cfg, TShape("t", S, B, "train"), step,
                          device="cpu")


def _rel(got, want):
    """||got - want|| / ||want|| (the error itself where want is zero, as
    dw is at S 1: S_{-1} is zero)."""
    err, scale = np.linalg.norm(_f32(got) - want), np.linalg.norm(want)
    return float(err / scale if scale else err)


# ---------------------------------------------------------------------------
# the plain backwards against jax.grad of the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", WKV_CASES, ids=map(_case_id, WKV_CASES))
def test_wkv_plain_backward_equals_jax_grad_of_the_oracle(ref, case):
    r, k, v, w, u, dy = map(torch.from_numpy, _wkv_inputs(*case))
    got = twkv.wkv_bwd_plain(r, k, v, w, u, dy)
    for name, g in zip(("dr", "dk", "dv", "dw", "du"), got):
        want = ref[f"wkv/{_case_id(case)}/{name}"]
        assert g.shape == want.shape and g.dtype == torch.float32
        assert _rel(g, want) <= 1e-4, (name, _rel(g, want))


# the ragged S of each head size and decay in turn, and the chunk crossing
WKV_STATE_CASES = [c for c in WKV_CASES if c[1] > 1][::2]


@pytest.mark.parametrize("case", WKV_STATE_CASES,
                         ids=map(_case_id, WKV_STATE_CASES))
def test_wkv_final_state_gradient_equals_autograd_of_the_plain_forward(
        case):
    r, k, v, w, u, dy = map(torch.from_numpy, _wkv_inputs(*case))
    b, _, h, n = r.shape
    ds = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, h, n, n)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, s_fin = twkv.wkv_plain(*leaves)
    ((y * dy).sum() + (s_fin * ds).sum()).backward()
    got = twkv.wkv_bwd_plain(r, k, v, w, u, dy, ds)
    for g, leaf in zip(got, leaves):
        want = leaf.grad.numpy()
        assert _rel(g, want) <= 1e-4


@pytest.mark.parametrize("case", SCAN_CASES, ids=map(_case_id, SCAN_CASES))
def test_scan_plain_backward_equals_jax_grad_of_the_oracle(ref, case):
    x, dt, bm, cm, a, d, dy = map(torch.from_numpy, _scan_inputs(*case))
    got = tss.selective_scan_bwd_plain(x, dt, bm, cm, a, d, dy)
    for name, g in zip(("dx", "ddt", "db", "dc", "da", "dd"), got):
        want = ref[f"scan/{_case_id(case)}/{name}"]
        assert g.shape == want.shape and g.dtype == torch.float32
        assert _rel(g, want) <= 1e-4, (name, _rel(g, want))


@pytest.mark.parametrize("case", SCAN_CASES, ids=map(_case_id, SCAN_CASES))
def test_scan_final_state_gradient_equals_autograd_of_the_plain_forward(
        case):
    x, dt, bm, cm, a, d, dy = map(torch.from_numpy, _scan_inputs(*case))
    dh = torch.from_numpy(np.random.default_rng(4).normal(
        size=(x.shape[0], x.shape[2], a.shape[1])).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bm, cm, a, d)]
    y, h_fin = tss.selective_scan_plain(*leaves)
    ((y * dy).sum() + (h_fin * dh).sum()).backward()
    got = tss.selective_scan_bwd_plain(x, dt, bm, cm, a, d, dy, dh)
    for g, leaf in zip(got, leaves):
        assert _rel(g, leaf.grad.numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# loss_fn gradients and steps of the smoke configs
# ---------------------------------------------------------------------------
class RouterMargins:
    """Records, while entered, the smallest gap between the k-th and the
    (k+1)-th router probability of any token in any MoE layer, by standing
    in for ``moe.moe_apply`` (the transformer's call site)."""

    def __init__(self):
        self.real = tmoe.moe_apply
        self.smallest = float("inf")

    def __enter__(self):
        def recorded(params, moe, x, *a, **kw):
            with torch.no_grad():
                logits = (x.reshape(-1, x.shape[-1]).float()
                          @ params["router"].float())
                top = torch.topk(torch.softmax(logits, -1), moe.top_k + 1,
                                 dim=-1).values
                gap = float((top[:, -2] - top[:, -1]).min())
            self.smallest = min(self.smallest, gap)
            return self.real(params, moe, x, *a, **kw)
        tmoe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        tmoe.moe_apply = self.real


@pytest.mark.parametrize("name,pname", MODEL_CASES,
                         ids=[f"{c}-{p}" for c, p in MODEL_CASES])
def test_loss_fn_gradients_equal_jax_grad(ref, name, pname):
    cfg = CONFIGS[name]
    params = tree_map(lambda t: t.requires_grad_(True), bridge.to_torch(
        _unflatten(ref, f"{name}/params"), "cpu"))
    batch = _batch(cfg)
    with RouterMargins() as margins:
        loss = TT.loss_fn(params, cfg, batch["tokens"], batch["labels"],
                          _port_plan(pname, cfg))
    loss.backward()
    want_l = float(ref[f"{name}/{pname}/loss"])
    got, want = {}, {}
    _flatten(tree_map(lambda t: t.grad, params), "", got)
    _flatten(_unflatten(ref, f"{name}/{pname}/grad"), "", want)
    assert sorted(got) == sorted(want)
    l_tol = 1e-6 if pname == "f32" else 2 ** -7
    assert abs(float(loss.detach()) - want_l) <= l_tol * abs(want_l)
    norm = lambda g: np.sqrt(sum(float(np.sum(np.square(_f32(v))))
                                 for v in g.values()))
    tol = 1e-4 if pname == "f32" else LOW_TOL
    if pname != "f32" and margins.smallest < MOE_TIE:
        # a near-tie at the top-k boundary: the routing may part
        np.testing.assert_allclose(norm(got), norm(want), rtol=5e-2)
        return
    errs = {k: _rel(got[k], want[k]) for k in want if np.any(want[k])}
    assert max(errs.values()) <= tol, errs


@pytest.mark.parametrize("pname", STEP_TOL)
def test_three_rwkv_steps_equal_the_reference(ref, pname):
    cfg = tr.SMOKE
    step = ttrain.make_step_fn(cfg, TTrain(**TC_KW), _port_plan(pname, cfg),
                               1)
    l_tol, n_tol, max_tol, mean_tol = STEP_TOL[pname]
    tree = lambda s, what: bridge.to_torch(
        _unflatten(ref, f"step/{pname}/{s}/{what}"), "cpu")
    for s in range(STEPS):
        count = torch.tensor(int(ref[f"step/{pname}/{s}/count"]),
                             dtype=torch.int32)
        state = ttrain.TrainState(tree(s, "params"), tadamw.AdamWState(
            tree(s, "mu"), tree(s, "nu"), count),
            torch.tensor(s, dtype=torch.int32))
        state, m = step(state, _batch(cfg, s))
        want_l = float(ref[f"step/{pname}/{s}/loss"])
        want_n = float(ref[f"step/{pname}/{s}/grad_norm"])
        assert abs(float(m["loss"]) - want_l) <= l_tol * want_l, s
        assert abs(float(m["grad_norm"]) - want_n) <= n_tol * want_n, s
        got, want = {}, {}
        _flatten(state.params, "", got)
        _flatten(_unflatten(ref, f"step/{pname}/{s + 1}/params"), "", want)
        assert sorted(got) == sorted(want)
        for k in want:
            diff = np.abs(_f32(got[k]) - want[k])
            assert diff.max() <= max_tol, (s, k, diff.max())
            assert diff.mean() <= mean_tol, (s, k, diff.mean())


def test_remat_recomputes_the_recurrent_mixers_to_the_same_gradient():
    """``cfg.remat`` reruns each super-block, wkv and scan included, in the
    backward pass: the loss and every gradient are bit-equal without it,
    and the gradient reaches every leaf of the mixers (``w0``, ``wA``,
    ``wB`` through ``_decay``, ``u``, ``A_log``, ``D``, ``dt_proj``, the
    projections)."""
    for cfg in CONFIGS.values():
        params = TT.model_init(cfg, torch.Generator().manual_seed(1), "cpu")
        batch = _batch(cfg)
        out = []
        for remat in (False, True):
            p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                         params)
            loss = TT.loss_fn(p, cfg.with_(remat=remat), batch["tokens"],
                              batch["labels"])
            loss.backward()
            grads = {}
            _flatten(tree_map(lambda t: t.grad, p), "", grads)
            out.append((loss.detach(), grads))
        assert torch.equal(out[0][0], out[1][0])
        assert all(np.array_equal(out[0][1][k], out[1][1][k])
                   for k in out[0][1])
        mixers = {k: g for k, g in out[1][1].items() if "/mixer/" in k}
        assert mixers and all(np.any(g) for g in mixers.values()), [
            k for k, g in mixers.items() if not np.any(g)]


def test_a_donated_update_equals_the_pure_one(monkeypatch):
    """The ``Trainer``'s step updates its state in place (the reference's
    jit donates it), a block of rows at a time: bit-equal to the pure
    update, and written into the tensors it was given."""
    monkeypatch.setattr(tadamw, "DONATE_BLOCK", 100)
    cfg = tr.SMOKE
    params = TT.model_init(cfg, torch.Generator().manual_seed(3), "cpu")
    grads = tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator(
        ).manual_seed(p.numel())), params)
    opt = tadamw.init(params)
    opt = opt._replace(mu=tree_map(lambda g: g * 0.1, grads),
                       nu=tree_map(lambda g: g * g, grads),
                       count=torch.tensor(3, dtype=torch.int32))
    tc = TTrain(**TC_KW)
    pure = tadamw.apply_updates(params, grads, opt, tc)
    copy = lambda tree: tree_map(lambda t: t.clone(), tree)
    mine, mine_opt = copy(params), opt._replace(mu=copy(opt.mu),
                                                nu=copy(opt.nu))
    done = tadamw.apply_updates(mine, grads, mine_opt, tc, donate=True)
    for a, b in zip(tree_leaves(pure[:2]), tree_leaves(done[:2])):
        assert torch.equal(a, b)
    assert torch.equal(pure[2], done[2])
    for given, out in zip(tree_leaves((mine, mine_opt.mu, mine_opt.nu)),
                          tree_leaves((done[0], done[1].mu, done[1].nu))):
        assert given is out


# ---------------------------------------------------------------------------
# the backward kernels on the card
# ---------------------------------------------------------------------------
# (B, S, H, N): the RWKV-6 3B layer's 40 heads of 64 at a short and a
# chunk-crossing S, the smoke config's 16, the smallest compiled 8
WKV_CARD_CASES = [(2, 37, 40, 64), (1, 130, 40, 64), (2, 70, 4, 16),
                  (3, 1, 2, 8), (1, 65, 3, 32)]
# (B, S, D, N): Jamba's d_inner 8192 at N 16, a ragged D, every state size
SCAN_CARD_CASES = [(2, 37, 8192, 16), (1, 130, 100, 16), (2, 9, 40, 4),
                   (1, 70, 33, 8), (2, 9, 50, 32), (1, 9, 20, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _card_rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CARD_CASES,
                         ids=map(_case_id, WKV_CARD_CASES))
def test_wkv_backward_kernel_equals_its_plain_version(card, case):
    b, s, h, n = case
    r, k, v, w, u, dy = (torch.from_numpy(t).to(card)
                         for t in _wkv_inputs(b, s, h, n, "near1"))
    ds = torch.randn((b, h, n, n), device=card)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    before = (twkv.wkv.launches, twkv.wkv_bwd.launches)
    y, s_fin = twkv.wkv(*leaves)
    ((y * dy).sum() + (s_fin * ds).sum()).backward()
    assert (twkv.wkv.launches, twkv.wkv_bwd.launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = twkv.wkv_bwd_plain(r, k, v, w, u, dy, ds)
    for leaf, g in zip(leaves, want):
        assert torch.isfinite(leaf.grad).all()
        assert _card_rel(leaf.grad, g) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CARD_CASES,
                         ids=map(_case_id, SCAN_CARD_CASES))
def test_scan_backward_kernel_equals_its_plain_version(card, case):
    x, dt, bm, cm, a, d, dy = (torch.from_numpy(t).to(card)
                               for t in _scan_inputs(*case))
    dh = torch.randn((case[0], case[2], case[3]), device=card)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, bm, cm, a, d)]
    before = (tss.selective_scan.launches, tss.selective_scan_bwd.launches)
    y, h_fin = tss.selective_scan(*leaves)
    ((y * dy).sum() + (h_fin * dh).sum()).backward()
    assert (tss.selective_scan.launches,
            tss.selective_scan_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = tss.selective_scan_bwd_plain(x, dt, bm, cm, a, d, dy, dh)
    for leaf, g in zip(leaves, want):
        assert torch.isfinite(leaf.grad).all()
        # ex2.approx (relative error ~2**-22) against exp
        assert _card_rel(leaf.grad, g) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wkv", "selective_scan"])
def test_backward_kernels_are_deterministic(card, kernel):
    if kernel == "wkv":
        args = [torch.from_numpy(t).to(card)
                for t in _wkv_inputs(2, 300, 40, 64, "near1")]
        _, _, ckpt = twkv._launch(*args[:5], checkpoints=True)
        run = lambda: twkv.wkv_bwd(*args[:5], ckpt, args[5])
    else:
        args = [torch.from_numpy(t).to(card)
                for t in _scan_inputs(1, 300, 8192, 16)]
        _, _, ckpt = tss._launch(*args[:6], checkpoints=True)
        run = lambda: tss.selective_scan_bwd(*args[:6], ckpt, args[6])
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [16, 1100], ids=["flat", "grouped"])
def test_moe_dispatch_backward_is_deterministic(card, seq):
    """The MoE dispatch (``index_put_(..., accumulate=True)`` and the
    gathers after it) on the card under autograd: each (expert, slot) takes
    one token, so two backward passes give the same bits, on the flat
    dispatch (``t * k <= 4096``) and on the per-row capacity buffers."""
    cfg = tj.SMOKE
    params = TT.model_init(cfg, torch.Generator().manual_seed(2), "cpu")
    mlp = tree_map(lambda t: t[0].to(card), params["layers"]["sub_1"]["mlp"])
    x = torch.randn((2, seq, cfg.d_model), device=card)
    runs = []
    for _ in range(2):
        leaves = tree_map(lambda t: t.clone().requires_grad_(True), mlp)
        xx = x.clone().requires_grad_(True)
        out, aux = tmoe.moe_apply(leaves, cfg.moe, xx, cfg.act, cfg.glu)
        (out.square().sum() + aux).backward()
        runs.append([xx.grad] + [t.grad for t in tree_leaves(leaves)])
    assert all(torch.equal(p, q) for p, q in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_bf16_step_on_the_card_equals_the_cpu(card, name):
    """One bf16 step of each smoke config on the card (the wkv or scan
    kernels, their backwards, flash and its backward) against the CPU's
    plain versions: loss within 2 bf16 ulps, parameters within
    ``STEP_TOL["bf16"]`` (a first Adam step is +-lr a weight)."""
    cfg = CONFIGS[name]
    tc = TTrain(**TC_KW)
    states, metrics = [], []
    for dev in ("cpu", card):
        params = TT.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda t: t.to(dev), params)
        state = ttrain.TrainState(params, tadamw.init(params),
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev))
        s, m = ttrain.make_step_fn(cfg, tc, None, 1)(
            state, tpipe.lm_batch(cfg, TShape("t", 64, 4, "train"), 0,
                                  device=dev))
        states.append(s)
        metrics.append(m)
    lc, lg = float(metrics[0]["loss"]), float(metrics[1]["loss"])
    assert abs(lc - lg) <= 2 * 2 ** (np.floor(np.log2(lc)) - 7)
    for a, b in zip(tree_leaves(states[0].params),
                    tree_leaves(states[1].params)):
        d = (a - b.cpu()).abs()
        assert float(d.max()) <= 2.2 * tc.learning_rate
        assert float(d.mean()) <= STEP_TOL["bf16"][3]


if __name__ == "__main__":
    _reference(sys.argv[1])
