"""Named device meshes over ``torch.distributed``: the port of the
reference's ``launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``pod``, ``data``, ``model``; ``clients`` for the
FL shard engine) over ranks 0 … prod(shape) − 1 of a world that is
already initialised: one process per rank (``torchrun``, or
``init_process_group`` with a ``file://`` store), NCCL for ``cuda`` and
gloo for ``cpu``. A world larger than the mesh keeps its first ranks, as
``jax.make_mesh`` keeps the first devices; the others hold no coordinate
(``in_mesh``) and take no part in what runs over the mesh. Building one is
a collective: every rank of the world calls it. The device type comes from
the caller: ``cuda`` by default, ``cpu`` must be asked for.

``AbstractMesh`` holds axis names and sizes only, the counterpart of
``jax.sharding.AbstractMesh``: the sharding specs (``dist/sharding.py``)
read a mesh only through its names and sizes, so they take one, and the
production shapes are held without a world of 256 or 512 ranks.
"""

from __future__ import annotations

import math

import torch.distributed as dist

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """Axis names and sizes, no devices: ``shape`` and ``mesh_dim_names`` as
    a ``DeviceMesh`` has them."""

    def __init__(self, shape, axes):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
        self.shape = shape
        self.mesh_dim_names = axes

    def size(self, mesh_dim=None) -> int:
        return math.prod(self.shape) if mesh_dim is None else self.shape[mesh_dim]

    def __repr__(self):
        return f"AbstractMesh({dict(zip(self.mesh_dim_names, self.shape, strict=True))})"


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed world: call "
            "torch.distributed.init_process_group(...) on every rank first (torchrun, "
            "or a file:// store)")
    return dist.get_world_size()


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 …
    prod(shape) − 1 of the world, which must hold at least that many."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = _world()
    if world < math.prod(shape):
        raise ValueError(f"Number of devices {world} must be >= the product of mesh_shape "
                         f"{shape}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return DeviceMesh(device_type, torch.arange(math.prod(shape)).view(shape),
                      mesh_dim_names=axes)


def in_mesh(mesh) -> bool:
    """Whether this rank holds a coordinate of ``mesh`` (a world larger
    than the mesh leaves its last ranks out)."""
    return mesh.get_coordinate() is not None


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production meshes: (16, 16) = 256 ranks single-pod; (2, 16, 16) =
    512. The world must have exactly that many ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = _world()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of exactly "
                         f"{math.prod(shape)} ranks, got {world} (the meshes are "
                         f"{PRODUCTION_SHAPES[False][0]} on 256 and "
                         f"{PRODUCTION_SHAPES[True][0]} on 512)")
    return make_mesh(shape, axes, device_type)


def make_client_mesh(num_shards: int = 0, device_type: str = "cuda"):
    """1-D mesh laying FL clients out over the first ``num_shards`` ranks
    (axis name ``clients``). ``num_shards=0`` uses every rank; the shard
    engine takes the mesh's group (``FLSimulator(..., group=mesh)``)."""
    world = _world()
    n = num_shards or world
    if n > world:
        raise ValueError(
            f"requested {n} shards but only {world} devices are visible (start one "
            f"process per rank, e.g. with torchrun)")
    return make_mesh((n,), ("clients",), device_type)


def mesh_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def has_pod_axis(mesh) -> bool:
    return "pod" in mesh_axes(mesh)


def axis_size(mesh, axis: str) -> int:
    """The size of the named axis (1 when the mesh has no such axis)."""
    names = mesh_axes(mesh)
    return mesh.shape[names.index(axis)] if axis in names else 1
