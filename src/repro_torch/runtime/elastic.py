"""Elastic re-meshing: rebuild a coherent mesh from surviving devices (the
port of ``repro.runtime.elastic``; pure Python on ``MeshConfig``).

After a node failure the device count shrinks; training resumes on the
largest usable (data, model) grid.  The model axis is kept as large a
divisor of the original TP degree as the parameters' head-padding allows
(head padding was computed for the original tp; any divisor of it still
divides the padded head counts), so restored checkpoints reshard without
reshaping.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.configs.base import MeshConfig


def _divisors_desc(n: int) -> Sequence[int]:
    return sorted({d for d in range(1, n + 1) if n % d == 0}, reverse=True)


def choose_mesh(num_devices: int, prefer_model: int = 16,
                min_data: int = 1) -> MeshConfig:
    """Largest (data, model) grid with model | prefer_model that fits."""
    for model in _divisors_desc(prefer_model):
        if model > num_devices:
            continue
        data = num_devices // model
        if data >= min_data:
            return MeshConfig((data, model), ("data", "model"))
    return MeshConfig((1, 1), ("data", "model"))


def surviving_mesh(mesh_cfg: MeshConfig, lost_devices: int) -> MeshConfig:
    alive = mesh_cfg.num_devices - lost_devices
    if alive < 1:
        raise ValueError("no devices survive")
    return choose_mesh(alive, prefer_model=mesh_cfg.tp)
