"""The port's architecture registry against ``repro.configs``: the same
names in the same order, and for every name the same full and smoke
configs, field for field.  ``PoolSpec`` / ``FleetSpec`` resolve ``arch``
through this registry, so a fleet JSON names the same model in both
packages."""
from dataclasses import asdict

import pytest

import repro.configs as ref
from repro_torch import configs


def test_registry_names_equal_the_reference():
    assert configs.ARCH_NAMES == ref.ARCH_NAMES
    assert len(configs.ARCH_NAMES) == 10


@pytest.mark.parametrize("arch", ref.ARCH_NAMES)
def test_full_and_smoke_configs_equal_the_reference(arch):
    for smoke in (False, True):
        want = ref.get_config(arch, smoke=smoke)
        got = configs.get_config(arch, smoke=smoke)
        assert asdict(got) == asdict(want)
        assert got.param_count() == want.param_count()
        assert ([got.layer_mixer(i) for i in range(got.num_layers)]
                == [want.layer_mixer(i) for i in range(want.num_layers)])


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")
    with pytest.raises(KeyError):
        ref.get_config("gpt-5")
