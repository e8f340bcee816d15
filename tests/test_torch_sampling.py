"""The port's key stream and sampler against ``jax.random`` and
``repro.runtime.sampling.sample_logits``, in one process on the CPU.

Integer results are equal bit for bit: key data from ``PRNGKey`` and
``fold_in`` (negative seeds, ``2**31 - 1``, step indices past ``2**31``),
``random_bits`` in jax's partitionable threefry layout, and the uniforms
built from them.  Gumbel noise applies two logs, and torch's ``log`` and
XLA's may differ by an ulp; near ``u = 1/e`` the outer log cancels, so the
noise is held within 4 ulps of ``max(1, |g|)``, the scale of the outer
log's argument.  Sampled tokens are equal unless the reference's top two
of ``gumbel + scaled`` lie within that tolerance of each other (the
near-tie rule the greedy tests apply to logits).

On a CUDA card (marker ``cuda``): key data, bits and samples computed on
the card equal the CPU's.  The card has no JAX, so the reference is
imported only inside the fixtures that use it; there, run

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_sampling.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.runtime.sampling import sample_logits

SEEDS = (0, 1, 42, -1, -7, 2**31 - 1, -2**31)
STEPS = (0, 1, 5, 2**31 - 1, 2**31, 2**32 - 1)
SHAPES = ((1,), (7,), (3, 5), (2, 3, 4), (1000,))
GUMBEL_ULPS = 4
EPS32 = 2.0 ** -23


@pytest.fixture(scope="module")
def jr():
    """``jax.random``, ``jax.numpy`` and the reference sampler (absent
    where the card is)."""
    jax = pytest.importorskip("jax")
    from repro.runtime import sampling
    return jax, jax.numpy, jax.jit(sampling.sample_logits)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _key(jax, seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(np.int32(seed)),
                              np.uint32(step))


def _data(jax, key) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(jax.random.key_data(key)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_equals_jax(jr, seed):
    jax = jr[0]
    base = prng.threefry_seed(torch.tensor(seed, dtype=torch.int32))
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(np.int32(seed))))
    assert base.tolist() == want.astype(np.int64).tolist()
    for step in STEPS:
        got = prng.fold_in(base, torch.tensor(step))
        assert got.tolist() == _data(jax, _key(jax, seed, step)).tolist(), \
            (seed, step)
    # a batch of keys folds each row with its own step
    seeds = torch.tensor([seed] * len(STEPS), dtype=torch.int32)
    got = prng.fold_in(prng.threefry_seed(seeds), torch.tensor(STEPS))
    want = torch.stack([_data(jax, _key(jax, seed, s)) for s in STEPS])
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniforms_equal_jax(jr, seed):
    jax, jnp = jr[0], jr[1]
    for step in STEPS[:4]:
        key = _key(jax, seed, step)
        for shape in SHAPES:
            want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
            got = prng.random_bits(_data(jax, key), shape)
            assert got.shape == shape
            assert (got.numpy() == want.astype(np.int64)).all(), \
                (seed, step, shape)
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
            want = np.asarray(jax.random.uniform(key, (4096,), jnp.float32,
                                                 lo, hi))
            got = prng.uniform(_data(jax, key), (4096,), lo, hi).numpy()
            assert (got.view(np.int32) == want.view(np.int32)).all()


def test_threefry_2x32_equals_jax(jr):
    """The block function on counter pairs: jax's ``threefry_2x32`` hashes
    the two halves of an even count as the pairs' two words."""
    jax = jr[0]
    from jax._src import prng as jprng
    key = jax.random.PRNGKey(3)
    for n in (1, 4, 33):
        count = (np.arange(2 * n, dtype=np.uint64) * 2654435761 % 2**32
                 ).astype(np.uint32)
        want = np.asarray(jprng.threefry_2x32(key, jax.numpy.asarray(count)))
        k = _data(jax, key)
        x = torch.as_tensor(count.astype(np.int64))
        got = torch.cat(prng.threefry_2x32(k[0], k[1], x[:n], x[n:]))
        assert (got.numpy() == want.astype(np.int64)).all(), n


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_four_ulps_of_jax(jr, seed):
    jax = jr[0]
    key = _key(jax, seed, 3)
    want = np.asarray(jax.random.gumbel(key, (20000,)), np.float64)
    got = prng.gumbel(_data(jax, key), (20000,)).numpy().astype(np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= GUMBEL_ULPS * EPS32, err.max() / EPS32


def _logits(rng, b, v, ties: bool):
    x = rng.normal(size=(b, v)).astype(np.float32) * 3
    if ties:      # a coarse grid: many rows hold ties at the k-th value
        x = np.round(x * 2) / 2
    return x


def _near_tie(jax, jnp, logits, temps, topks, seeds, steps, row):
    """The reference's top two of ``gumbel + scaled`` for ``row``."""
    l = jnp.asarray(logits[row])
    k = int(topks[row])
    if k > 0:
        kth = jnp.sort(l)[::-1][min(max(k - 1, 0), l.shape[0] - 1)]
        l = jnp.where(l < kth, -jnp.inf, l)
    scaled = l / jnp.maximum(jnp.float32(temps[row]), 1e-6)
    key = _key(jax, int(seeds[row]), int(steps[row]))
    z = np.sort(np.asarray(jax.random.gumbel(key, scaled.shape) + scaled))
    return float(z[-1]), float(z[-2])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("temp", [0.0, 0.5, 1.0, 2.0])
def test_sample_logits_tokens_equal_the_reference(jr, temp, ties):
    jax, jnp, ref = jr
    rng = np.random.default_rng(int(temp * 10) + 100 * ties)
    b, v = 16, 64
    logits = _logits(rng, b, v, ties)
    topks = np.array([0, 1, 8, v] * (b // 4), np.int32)
    temps = np.full(b, temp, np.float32)
    temps[::5] = 0.0                         # greedy rows ride along
    seeds = np.array(SEEDS * 3, np.int64)[:b].astype(np.int32)
    steps = rng.integers(0, 2**31 - 1, b).astype(np.int32)
    want = np.asarray(ref(jnp.asarray(logits), jnp.asarray(temps),
                          jnp.asarray(topks), jnp.asarray(seeds),
                          jnp.asarray(steps)))
    got = sample_logits(torch.as_tensor(logits), torch.as_tensor(temps),
                        torch.as_tensor(topks), torch.as_tensor(seeds),
                        torch.as_tensor(steps)).numpy()
    assert (got[temps == 0] == want[temps == 0]).all()
    assert (got[topks == 1] == logits[topks == 1].argmax(-1)).all()
    for row in np.flatnonzero(got != want):
        top, second = _near_tie(jax, jnp, logits, temps, topks, seeds,
                                steps, row)
        assert top - second <= GUMBEL_ULPS * EPS32 * max(1.0, abs(top)), (
            f"row {row}: token {got[row]} vs the reference's {want[row]} "
            f"with top-2 margin {top - second}")
    if ties:
        # the coarse grid put ties at the k-th value of the top-8 rows
        kth = -np.sort(-logits, axis=1)[:, 7]
        assert ((logits == kth[:, None]).sum(1) > 1).any()


def test_sample_logits_with_bf16_logits_matches_the_reference(jr):
    """The engine hands the sampler its bf16 lm-head logits."""
    jax, jnp, ref = jr
    import ml_dtypes
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(8, 256)) * 4).astype(ml_dtypes.bfloat16)
    temps = np.array([1.0, 0.7, 0.0, 1.0, 2.0, 0.7, 1.0, 0.3], np.float32)
    topks = np.array([0, 50, 0, 1, 8, 0, 256, 3], np.int32)
    seeds = np.array([42, -1, 0, 7, 2**31 - 1, 3, -9, 11], np.int32)
    steps = np.arange(8, dtype=np.int32) * 3
    want = np.asarray(ref(jnp.asarray(logits), jnp.asarray(temps),
                          jnp.asarray(topks), jnp.asarray(seeds),
                          jnp.asarray(steps)))
    got = sample_logits(
        torch.as_tensor(logits.astype(np.float32)).bfloat16(),
        torch.as_tensor(temps), torch.as_tensor(topks),
        torch.as_tensor(seeds), torch.as_tensor(steps)).numpy()
    for row in np.flatnonzero(got != want):
        top, second = _near_tie(jax, jnp, logits.astype(np.float32), temps,
                                topks, seeds, steps, row)
        assert top - second <= GUMBEL_ULPS * EPS32 * max(1.0, abs(top))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_key_stream_on_card_equals_cpu(cuda, seed):
    steps = torch.tensor(STEPS)
    seeds = torch.full((len(STEPS),), seed, dtype=torch.int32)
    cpu = prng.fold_in(prng.threefry_seed(seeds), steps)
    card = prng.fold_in(prng.threefry_seed(seeds.to(cuda)), steps.to(cuda))
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), cpu)
    for shape in SHAPES + ((8, 151936),):
        assert torch.equal(prng.random_bits(card[:1], shape).cpu(),
                           prng.random_bits(cpu[:1], shape))
    u_cpu = prng.uniform(cpu, (4096,), float(np.finfo(np.float32).tiny))
    u_card = prng.uniform(card, (4096,), float(np.finfo(np.float32).tiny))
    assert torch.equal(u_card.cpu(), u_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("temp", [0.0, 0.7, 1.0])
def test_sample_logits_on_card_equals_cpu(cuda, temp):
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(8, 151936, generator=gen) * 4
    temps = torch.full((8,), temp)
    topks = torch.tensor([0, 1, 50, 0, 1, 50, 0, 50], dtype=torch.int32)
    seeds = torch.tensor(SEEDS + (9,), dtype=torch.int32)
    steps = torch.arange(8, dtype=torch.int32) * 1000
    args = (logits, temps, topks, seeds, steps)
    cpu = sample_logits(*args)
    card = sample_logits(*(a.to(cuda) for a in args))
    for row in torch.nonzero(card.cpu() != cpu).flatten().tolist():
        l = logits[row]
        if int(topks[row]) > 0:
            kth = torch.sort(l, descending=True).values[int(topks[row]) - 1]
            l = torch.where(l < kth, float("-inf"), l)
        keys = prng.fold_in(prng.threefry_seed(seeds[row:row + 1]),
                            steps[row:row + 1])
        z = prng.gumbel(keys, (151936,))[0] + l / max(temp, 1e-6)
        top2 = torch.topk(z, 2).values
        assert top2[0] - top2[1] <= GUMBEL_ULPS * EPS32 * max(
            1.0, abs(float(top2[0])))
