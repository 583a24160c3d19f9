"""What ``shard_map``'s named axes give the reference, over a
``torch.distributed`` ``DeviceMesh``.

The reference's ``_compat.py`` is a ``shard_map`` version shim; its
collectives name a mesh axis (``lax.psum(x, "data")``,
``lax.axis_index("model")``) and XLA finds the devices.  Here a mesh
axis is a process group: ``mesh.get_group(axis)`` and
``mesh.get_local_rank(axis)``.  The rules kept by every caller:

  * an axis's size, rank and group come from the mesh, and a
    collective's group is ALWAYS its axis's group, never the default
    group (on a (data, model) mesh the default group spans both axes);
  * an axis of size 1 (a world of one, or a mesh axis of 1) issues no
    collective at all: the helpers return their input;
  * an axis the mesh does not have counts as size 1, as the reference's
    ``dict(...).get(name, 1)``.

``mesh`` is a ``DeviceMesh`` or, for the sharding rules, which read
names and sizes only, a ``launch.mesh.MeshShape``.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(axis_names(mesh), (int(n) for n in mesh.shape)))


def axis_size(mesh, axis: str) -> int:
    return axis_sizes(mesh).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    """This process's index on ``axis`` (0 on an axis of size 1, and on
    a ``MeshShape``, which stands for rank 0)."""
    if axis_size(mesh, axis) == 1 or not hasattr(mesh, "get_local_rank"):
        return 0
    return int(mesh.get_local_rank(axis))


def axes_rank(mesh, axes) -> Tuple[int, int]:
    """(this process's index over ``axes`` in row-major order, their
    size product): the chunk a dim split over ``axes`` gives it."""
    idx, n = 0, 1
    for a in axes:
        size = axis_size(mesh, a)
        idx, n = idx * size + axis_rank(mesh, a), n * size
    return idx, n


def axis_group(mesh, axis: str):
    """The process group of ``axis``: the ranks that differ only there."""
    return mesh.get_group(axis)


def all_reduce(t: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """``t`` reduced in place over ``axis`` (op "sum" or "max") and
    returned; no collective on an axis of size 1."""
    if axis_size(mesh, axis) == 1:
        return t
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, op=red, group=axis_group(mesh, axis))
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``t`` on ``axis`` concatenated along ``dim`` in rank
    order (``lax.all_gather(..., tiled=True)``); ``t`` on an axis of
    size 1."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    import torch.distributed as dist
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=axis_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """``t`` summed over ``axis``, this rank's 1/n of it along ``dim``
    (``lax.psum_scatter(..., tiled=True)``); ``t`` on an axis of size 1.

    The collective follows the group's backend: gloo has no
    reduce-scatter for CUDA tensors, so over gloo it is an all-reduce of
    ``t`` and this rank's chunk of the sum (n times the bytes, the same
    values); NCCL and the dry-run's fake backend run ``reduce_scatter``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    import torch.distributed as dist
    group = axis_group(mesh, axis)
    if dist.get_backend(group) == "gloo":
        full = all_reduce(t.contiguous().clone(), "sum", mesh, axis)
        return full.chunk(n, dim=dim)[axis_rank(mesh, axis)].contiguous()
    parts = [p.contiguous() for p in t.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_reduce_sum_grad(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` summed over ``axis`` with a gradient (out of place: the
    gradient of every input is the sum of the output gradients over the
    group); ``t`` on an axis of size 1."""
    if axis_size(mesh, axis) == 1:
        return t
    from torch.distributed.nn.functional import all_reduce as ar
    # deprecated in favour of _functional_collectives.all_reduce, which
    # has no gradient: keep the one warning out of every training step
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return ar(t, group=axis_group(mesh, axis))
