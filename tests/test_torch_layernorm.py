"""The port's ``layernorm_init`` / ``layernorm`` / ``make_norm``
(``repro_torch.models.layers``) against ``repro.models.layers`` on
seeded f32 and bf16 inputs, run in-process.

Both compute in f32 with the two-pass mean and variance and round once to
the input's dtype.  XLA and torch sum the last dim in different orders, so
f32 outputs are held to 1e-6 relative and bf16 outputs to one bf16 ulp of
their largest magnitude."""
import numpy as np
import pytest
import torch

from repro_torch.models import layers as TL


def _inputs():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(3, 5, 96)) * 4 + 1.5).astype(np.float32)
    scale = rng.normal(size=(96,)).astype(np.float32)
    bias = rng.normal(size=(96,)).astype(np.float32)
    return x, {"scale": scale, "bias": bias}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_equals_the_reference(dtype):
    import jax.numpy as jnp
    from repro.models import layers as JL
    x, params = _inputs()
    want = JL.layernorm({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = TL.layernorm({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == dtype
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp


def test_layernorm_init_matches_the_reference():
    from repro.models import layers as JL
    want = JL.layernorm_init(96)
    got = TL.layernorm_init((96,), "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_make_norm_names():
    assert TL.make_norm("rmsnorm") == (TL.rmsnorm_init, TL.rmsnorm)
    assert TL.make_norm("layernorm") == (TL.layernorm_init, TL.layernorm)
    with pytest.raises(ValueError):
        TL.make_norm("batchnorm")
