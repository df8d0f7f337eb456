"""Production meshes and the H100's constants (counterpart of
``repro.launch.mesh``).

The reference builds its production mesh from 512 placeholder CPU devices
and AOT-compiles on it. Here no rank exists for a 256- or 512-rank mesh,
so ``make_production_mesh`` returns a plain description of it (axis names,
shape, sizes), which is all the dry run reads. ``make_host_mesh`` builds a
real ``torch.distributed`` ``DeviceMesh`` over the ranks of an initialised
process group: gloo on the CPU in the tests, one NCCL rank on the card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.device import resolve
from repro_torch.dist.sharding import MeshAxes

# NVIDIA H100 SXM (data sheet), per card: dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s, and NVLink 4's bytes/s per direction summed over its 18
# links of 25 GB/s each
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK4_BW_PER_DIRECTION = 18 * 25e9


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh without ranks: axis names and their sizes, major first."""

    axis_names: tuple
    shape: tuple

    @property
    def mesh_dim_names(self) -> tuple:
        """The axis names, under ``DeviceMesh``'s name for them."""
        return self.axis_names

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's 16 x 16 (data, model) mesh, or 2 x 16 x 16 (pod,
    data, model) with ``multi_pod``."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def mesh_axes(multi_pod: bool = False) -> MeshAxes:
    return MeshAxes(pod="pod") if multi_pod else MeshAxes()


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) ``DeviceMesh`` over the ranks of the initialised
    default group (``data * model`` of them); its device type comes from
    ``device.resolve(device)`` (default the card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: no process group — call "
                           "torch.distributed.init_process_group first")
    if dist.get_world_size() != data * model:
        raise ValueError(f"make_host_mesh: {data} x {model} does not cover "
                         f"the group's {dist.get_world_size()} ranks")
    return init_device_mesh(resolve(device).type, (data, model),
                            mesh_dim_names=("data", "model"))
