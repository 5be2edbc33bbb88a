"""Mesh construction for the production topology.

Defined as FUNCTIONS (never module-level constants), so importing this
module starts no process group: the card's paths and the tests see none,
while the dry run brings one up on first use.

A mesh here is a ``DeviceMesh`` of ``device_type="cpu"`` over the "fake"
process group of ``torch.testing._internal.distributed.fake_pg``: one
process plays rank 0 of a world of ``prod(shape)`` ranks, and collectives
complete at once without moving data.  The group is process-global, so
``make_mesh`` starts it with the world size the mesh needs and, when a mesh
of another size was made before, destroys that group first: one process can
price the 256-rank and the 512-rank meshes in turn, but a mesh made before
the switch is dead after it.

``axis_size`` and ``data_axes`` read a ``DeviceMesh`` or a plain
``{axis: size}`` mapping (the partition rules need only the sizes).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """Arbitrary mesh (tests use small ones, e.g. (2, 4))."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_process_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def fake_process_group(world_size: int) -> None:
    """Make the process rank 0 of a fake group of ``world_size`` ranks,
    destroying a group of another size first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pod folds into DP when present)."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)
