"""Mesh construction (the port of ``repro.launch.mesh``).  Functions, not
module constants — importing this module touches no device and no process
group.  Each function builds a ``torch.distributed`` ``DeviceMesh`` over
the process group the caller (or ``torchrun``) has initialised: one rank
a device of the mesh, ranks filling it in row-major order."""
from __future__ import annotations

from repro_torch.configs.base import MeshConfig, MULTI_POD, SINGLE_POD


def production_mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: ``(16, 16)`` ``("data", "model")``, or ``(2,
    16, 16)`` ``("pod", "data", "model")`` with ``multi_pod``, over a
    process group of 256 or 512 ranks (the dry run's is a fake one)."""
    return make_mesh_from_config(production_mesh_config(multi_pod=multi_pod))


def _device_type() -> str:
    """``cuda`` under NCCL; ``cpu`` under gloo, whose ranks may share a
    card, and under the dry run's fake backend (the mesh's device type
    only names where DTensors would live)."""
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh_from_config(mesh_cfg: MeshConfig):
    """A ``DeviceMesh`` of ``mesh_cfg``'s shape and axis names; the world
    must have exactly ``mesh_cfg.num_devices`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != mesh_cfg.num_devices:
        raise ValueError(f"need {mesh_cfg.num_devices} devices, have {have}")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed "
                           "process group (init_process_group or torchrun)")
    return init_device_mesh(_device_type(), tuple(mesh_cfg.shape),
                            mesh_dim_names=tuple(mesh_cfg.axes))


def make_local_mesh(model: int = 1):
    """Whatever the process group has: an (n/model, model) data x model
    grid of its n ranks."""
    import torch.distributed as dist

    n = dist.get_world_size()
    model = max(1, min(model, n))
    return make_mesh_from_config(MeshConfig((n // model, model),
                                            ("data", "model")))
