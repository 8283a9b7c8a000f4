"""Process meshes on torch.distributed for multi-GPU scaling.

Port of image_transformation_tpu/parallel/mesh.py. One process drives one
GPU (``torchrun --nproc-per-node N``); a mesh arranges the ranks of the
process group on two named dims:

- ``("data", "spatial")`` (:func:`make_mesh`): the canvas or variant batch
  shards over ``data`` (no communication on the compose path, collectives
  only for run-level statistics); canvas rows shard over ``spatial``;
- ``("slice", "data")`` (:func:`make_slice_mesh`): a two-level mesh whose
  leading dim stands for the slower link between hosts, so a reduction
  over both dims crosses it.

Where JAX's ``NamedSharding`` lets XLA place arrays, a rank here holds only
its own shard: a step takes the global tensors, keeps its piece
(:meth:`Sharding.local`), computes, and reduces the statistics over the
group of its batch dims (:meth:`Mesh.all_reduce_sum`).
:meth:`Sharding.gather` assembles a sharded result on every rank.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` built from
explicit process groups, one per dim slice (``DeviceMesh.from_group``). The
backend is the caller's (``"nccl"`` by default, ``"gloo"`` when asked) and
is never changed on its behalf: a group initialised with another backend
raises. Gloo moves host memory, so its collectives stage CUDA tensors
through the host (that is its transport). With no process group and no
``torchrun`` environment, :func:`make_mesh` starts a world of one on the
chosen device (an in-process store), so a mesh over "all visible
processes" works on a one-GPU machine.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device

BACKENDS = ("nccl", "gloo")

Axes = Union[str, Tuple[str, ...]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A 2-D arrangement of the process group's ranks with named dims.

    ``shape`` and ``dim_names`` describe the mesh; rank ``r`` sits at
    ``np.unravel_index(r, shape)``. ``device`` is this rank's device and
    ``backend`` the process group's. ``device_mesh`` is the
    ``DeviceMesh`` over the same groups (``get_group(dim)``)."""

    def __init__(self, shape: Tuple[int, ...], dim_names: Tuple[str, ...],
                 device: torch.device, backend: str, owns_group: bool = False):
        from torch.distributed.device_mesh import DeviceMesh

        self.shape = tuple(int(s) for s in shape)
        self.dim_names = tuple(dim_names)
        self.device = device
        self.backend = backend
        self.rank = dist.get_rank()
        self._owns_group = owns_group
        ranks = np.arange(self.size()).reshape(self.shape)
        self.coords = dict(zip(self.dim_names, np.unravel_index(self.rank, self.shape)))
        # every rank creates every group, in the same order (new_group's rule)
        groups = []
        for d in range(len(self.shape)):
            lines = np.moveaxis(ranks, d, -1).reshape(-1, self.shape[d])
            mine = None
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    mine = g
            groups.append(mine)
        self.device_mesh = DeviceMesh.from_group(
            groups, device.type, mesh=torch.from_numpy(ranks), mesh_dim_names=self.dim_names
        )

    def size(self, axes: Optional[Axes] = None) -> int:
        """Ranks along ``axes`` (all dims when None)."""
        if axes is None:
            return int(np.prod(self.shape))
        return int(np.prod([self.shape[self.dim_names.index(a)] for a in _axes(axes)]))

    def coordinate(self, axes: Axes, rank: Optional[int] = None) -> int:
        """The row-major index of ``rank`` (this rank by default) along
        ``axes``, in ``range(self.size(axes))``."""
        coords = (self.coords if rank is None else
                  dict(zip(self.dim_names, np.unravel_index(rank, self.shape))))
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[self.dim_names.index(a)] + int(coords[a])
        return idx

    def group(self, axes: Axes):
        """The process group of this rank's line along ``axes``: one dim's
        group, or the whole world when ``axes`` names every dim."""
        axes = _axes(axes)
        for a in axes:
            if a not in self.dim_names:
                raise ValueError(f"{a!r} is not a dim of mesh {self.dim_names}")
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if sorted(axes) == sorted(self.dim_names):
            return dist.group.WORLD
        raise ValueError(f"no single group spans {axes} of mesh {self.dim_names}")

    def _run(self, t: torch.Tensor, collective) -> torch.Tensor:
        if self.backend == "gloo" and t.device.type == "cuda":
            # gloo's transport is host memory: stage through it and back
            host = t.cpu()
            collective(host)
            t.copy_(host)
        else:
            collective(t)
        return t

    def all_reduce_sum(self, t: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Sum ``t`` IN PLACE over the ranks of ``axes``; returns ``t``."""
        group = self.group(axes)
        return self._run(t, lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group))

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), indexed by rank, on ``t``'s
        device."""
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type == "cuda":
            parts = [torch.empty_like(t, device="cpu") for _ in range(self.size())]
            dist.all_gather(parts, t.cpu())
            return [p.to(t.device) for p in parts]
        parts = [torch.empty_like(t) for _ in range(self.size())]
        dist.all_gather(parts, t)
        return parts

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        """Destroy the process group if :func:`make_mesh` started it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def __repr__(self) -> str:
        dims = ", ".join(f"{n}={s}" for n, s in zip(self.dim_names, self.shape))
        return f"Mesh({dims}; rank {self.rank} on {self.device}, {self.backend})"


def _check_backend(backend: str, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' runs on CUDA devices, not {device}; "
                         "ask for backend='gloo' to run on the CPU")


def _world(device, backend: str) -> Tuple[torch.device, bool]:
    """(this rank's device, whether this call started the group): the
    caller's group (its backend must be ``backend``), a torchrun world
    (``env://``; a CUDA ``device`` without an index is
    ``cuda:LOCAL_RANK``), or a world of one on an in-process store."""
    device = torch.device(device)
    torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if (device.type == "cuda" and device.index is None and torchrun
            and "LOCAL_RANK" in os.environ):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    device = resolve_device(str(device))
    if dist.is_initialized() and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh asks "
                         f"for {backend!r}: a backend is never switched")
    _check_backend(backend, device)
    if dist.is_initialized():
        return device, False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if torchrun:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return device, True


def make_mesh(data: Optional[int] = None, spatial: int = 1, device="cuda",
              backend: str = "nccl") -> Mesh:
    """A (data, spatial) mesh over the ranks of the process group, this
    rank on ``device``."""
    dev, owns = _world(device, backend)
    n = dist.get_world_size()
    if data is None:
        data = n // spatial
    if data * spatial != n:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"mesh {data}x{spatial} != {n} devices")
    return Mesh((data, spatial), ("data", "spatial"), dev, backend, owns)


def make_slice_mesh(slices: int = 2, data: Optional[int] = None, device="cuda",
                    backend: str = "nccl") -> Mesh:
    """A two-level (slice, data) mesh: collectives over both dims cross the
    leading one, as a reduction across hosts does."""
    dev, owns = _world(device, backend)
    n = dist.get_world_size()
    if data is None:
        if n % slices:
            if owns:
                dist.destroy_process_group()
            raise ValueError(f"{n} devices not divisible into {slices} slices")
        data = n // slices
    if slices * data != n:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"mesh {slices}x{data} != {n} devices")
    return Mesh((slices, data), ("slice", "data"), dev, backend, owns)


@dataclass(frozen=True)
class Sharding:
    """Where each dim of a global tensor lives on ``mesh``: ``spec[d]`` is
    the mesh dim (or tuple of dims, row-major) dim ``d`` splits over, or
    None (replicated); dims past ``spec`` are replicated."""

    mesh: Mesh
    spec: Tuple[Optional[Axes], ...] = ()

    def _blocks(self, shape, rank: Optional[int] = None):
        """(dim, block index, block count) of every sharded dim."""
        out = []
        for d, axes in enumerate(self.spec):
            if axes is None:
                continue
            count = self.mesh.size(axes)
            if shape[d] % count:
                raise ValueError(
                    f"dimension {d} of size {shape[d]} is not divisible by the mesh's "
                    f"{_axes(axes)} extent {count}")
            out.append((d, self.mesh.coordinate(axes, rank), count))
        return out

    def local(self, x):
        """This rank's piece of the global ``x`` (a view of a tensor, a
        slice of an array)."""
        for d, idx, count in self._blocks(x.shape):
            n = x.shape[d] // count
            index = [slice(None)] * x.ndim
            index[d] = slice(idx * n, (idx + 1) * n)
            x = x[tuple(index)]
        return x

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's ``local`` piece, on every
        rank (one all-gather over the world)."""
        parts = self.mesh.all_gather(local)
        full_shape = list(local.shape)
        for d, axes in enumerate(self.spec):
            if axes is not None:
                full_shape[d] *= self.mesh.size(axes)
        full = torch.empty(full_shape, dtype=local.dtype, device=local.device)
        for r, part in enumerate(parts):
            index = [slice(None)] * local.ndim
            for d, idx, count in self._blocks(full_shape, r):
                n = local.shape[d]
                index[d] = slice(idx * n, (idx + 1) * n)
            full[tuple(index)] = part
        return full


def shard_batched(mesh: Mesh, spatial_dim: Optional[int] = None,
                  batch_axes: Axes = "data") -> Sharding:
    """Sharding of a batched canvas tensor [B, H, W, C]: the batch over
    ``batch_axes`` ("data") and, with ``spatial_dim``, that dim over
    ``spatial``."""
    if spatial_dim is None:
        return Sharding(mesh, (batch_axes,))
    if spatial_dim == 0:
        # the batch dim cannot also be the spatial dim
        raise ValueError("spatial_dim 0 is the batch dim (sharded 'data')")
    spec: List[Optional[Axes]] = [None] * 4
    spec[0] = batch_axes
    spec[spatial_dim] = "spatial"
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    """A tensor every rank holds whole."""
    return Sharding(mesh, ())


__all__ = [
    "BACKENDS",
    "Mesh",
    "Sharding",
    "make_mesh",
    "make_slice_mesh",
    "replicated",
    "shard_batched",
]
