"""Device meshes of the port: the production 16x16 (and 2x16x16) meshes
and small host meshes, as ``torch.distributed`` ``DeviceMesh`` objects
with the reference's axis names.

Counterpart of ``repro/launch/mesh.py``.  Defined as FUNCTIONS, so
importing this module touches no process group and no device: a mesh is
built only when one of them is called, and then over the default process
group, which the caller initialises first (``launch.train
--production-mesh`` does, from ``torchrun``'s environment).  A mesh
covers the whole world: building one whose size is not the world size
raises, naming both numbers.

``MeshShape`` is the light stand-in the sharding rules read: axis names
and a shape, with no process group (``distributed.sharding`` takes it or
a ``DeviceMesh``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

PRODUCTION_AXES = ("data", "model")
PRODUCTION_SHAPE = (16, 16)
MULTI_POD_AXES = ("pod", "data", "model")
MULTI_POD_SHAPE = (2, 16, 16)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and shape, without devices or process groups."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{len(self.shape)}-d shape {self.shape}")

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


def production_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's names and shape, with no process group."""
    return MeshShape(MULTI_POD_AXES, MULTI_POD_SHAPE) if multi_pod \
        else MeshShape(PRODUCTION_AXES, PRODUCTION_SHAPE)


def world_size() -> int:
    """The default group's size (1 when no group is initialised)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group's ranks in row-major order.  The group must be initialised and
    its world size must equal the mesh's size."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    want = MeshShape(tuple(axes), tuple(shape))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {'x'.join(map(str, want.shape))} mesh needs an initialised "
            f"default process group of {want.size} ranks; none is "
            "initialised")
    n = dist.get_world_size()
    if n != want.size:
        raise RuntimeError(
            f"a {'x'.join(map(str, want.shape))} mesh {want.axis_names} "
            f"needs a world of {want.size} ranks; this world has {n}")
    return DeviceMesh(device_type,
                      torch.arange(want.size).reshape(want.shape),
                      mesh_dim_names=want.axis_names)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 ("data", "model"), 256 ranks; or 2x16x16 ("pod", "data",
    "model"), 512 ranks."""
    want = production_shape(multi_pod)
    return make_mesh(want.shape, want.axis_names, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ("data", "model") mesh, its axes clamped to the world size
    as the reference clamps them to the device count."""
    n = world_size()
    data = min(data, n)
    model = min(model, max(1, n // data))
    return make_mesh((data, model), PRODUCTION_AXES, device_type)
