"""Model configurations of the port (copies of ``repro.configs``) and the
architecture registry: ``--arch <id>`` and ``FleetSpec.arch`` resolve
here, and the dry-run cells (``cells``) are listed here.
"""
from __future__ import annotations

from repro_torch.configs.base import (LONG_500K, DECODE_32K,  # noqa: F401
                                      PREFILL_32K, TRAIN_4K, MeshConfig,
                                      ModelConfig, MoEConfig, MULTI_POD,
                                      ShapeConfig, SHAPES, SINGLE_POD,
                                      SMOKE_MESH, TrainConfig)

from repro_torch.configs import (jamba_v0_1_52b, llama3_405b,
                                 llava_next_mistral_7b, moonshot_v1_16b_a3b,
                                 musicgen_medium, olmoe_1b_7b, qwen3_14b,
                                 rwkv6_3b, stablelm_1_6b, starcoder2_15b)

_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "musicgen-medium": musicgen_medium,
    "qwen3-14b": qwen3_14b,
    "stablelm-1.6b": stablelm_1_6b,
    "llama3-405b": llama3_405b,
    "starcoder2-15b": starcoder2_15b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "rwkv6-3b": rwkv6_3b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = _MODULES[name]
    return mod.SMOKE if smoke else mod.FULL


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells.  long_500k only runs for archs with
    sub-quadratic decode state (the assignment's skip rule)."""
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            skip = (shape.name == "long_500k"
                    and not cfg.supports_long_context())
            if include_skipped or not skip:
                out.append((name, shape.name, skip))
    return out
