"""Process meshes and this rank's share of a batch.

Counterpart of ``mrijax/parallel/mesh.py``. In the JAX package a mesh lays
the devices of every host out on named axes and the partitioner inserts the
collectives; here each process drives one device, so a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
group, with ``mesh_dim_names`` the axis names:

* ``data``  — the batch axis: a rank takes the rows of its data index, and
  the train steps all-reduce the gradients over the axis' group;
* ``model`` — the token axis of the bottleneck attention
  (``parallel.sequence``): its ranks hold the same rows and split the query
  rows of the attention.

``mesh=None`` means one process: every helper then behaves as on an axis of
size 1. ``global_put`` and ``replicated_sharding`` of the JAX package have
no counterpart: every rank builds the same parameters from the same seed, so
there is nothing to place.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mrijax_torch.parallel.multihost import collective_device

# torch 2.13 names it all_gather_single; earlier releases all_gather_into_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def make_mesh(axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over every rank of the default process group, rank r at the
    row-major position r of ``shape``. With ``shape=None`` all ranks go to
    the first axis and the others get size 1 (pure data parallelism)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "mrijax_torch.parallel.initialize first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} does not name axes {tuple(axes)}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} processes")
    return DeviceMesh(collective_device().type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Size of ``axis`` (1 without a mesh or for an axis the mesh lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def global_rows(mesh: Optional[DeviceMesh], local_rows: int, axis: str = "data") -> int:
    """Rows of the global batch whose share on this rank is ``local_rows``."""
    return local_rows * axis_size(mesh, axis)


def local_rows(mesh: Optional[DeviceMesh], x: torch.Tensor, axis: str = "data"):
    """This rank's contiguous share of the leading axis of a global tensor
    (rows ``[i·B/n, (i+1)·B/n)`` for data index i of n)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    per = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * per:(i + 1) * per]


def shard_batch(mesh: Optional[DeviceMesh], batch, axis: str = "data"):
    """This rank's rows of a global batch (a tensor, an array or a dict of
    them; 0-d values pass through). The global batch must divide over the
    axis."""
    n = axis_size(mesh, axis)

    def take(x):
        if np.ndim(x) == 0:
            return x
        rows = np.shape(x)[0]
        if rows % n != 0:
            raise ValueError(
                f"global batch dim {rows} is not divisible by mesh axis "
                f"'{axis}' of size {n}; pick a batch size that is a multiple "
                f"of {n}, or start fewer processes")
        return local_rows(mesh, x, axis)

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)


def gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``x`` of the group's ``n`` ranks concatenated along the leading
    axis, in rank order, on every rank."""
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    return out


# a gradient all-reduce moves flat buffers of about this size, not one
# collective per parameter
_BUCKET_BYTES = 256 * 2 ** 20


def all_reduce_mean(tensors: List[torch.Tensor], group, n: int) -> None:
    """Mean over the group of each tensor, in place: SUM all-reduces of flat
    buffers that close once they reach ``_BUCKET_BYTES`` (a tensor larger
    than that is one bucket), then ÷ n."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    bucket, size = [], 0
    for i, t in enumerate(tensors):
        bucket.append(t)
        size += t.numel() * t.element_size()
        if size >= _BUCKET_BYTES or i == len(tensors) - 1:
            flat = _flatten_dense_tensors(bucket)
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            for dst, src in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                dst.copy_(src)
            bucket, size = [], 0
