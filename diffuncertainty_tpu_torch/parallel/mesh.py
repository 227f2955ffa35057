"""The (data, member) layout of the ranks (port of
``diffuncertainty_tpu/parallel/mesh.py``).

JAX shards arrays over a ``Mesh`` of devices and lets XLA insert the
collectives. The port runs one process per device, so a mesh here is a
layout of the process group's ranks (rank = the row-major index of its
coordinates, as JAX reshapes its device list) with one ``new_group`` per line
of each axis; each rank keeps its rows of a batch (``data``) and its slice of
a stacked state dict (``member``) and gathers along an axis with
``all_gather_into_tensor``:

- ``data``: batch rows, for training (the gradients are averaged over it)
  and inference;
- ``member``: ensemble members, SWAG draws and sub-ensemble masks: a
  stacked state dict's leading axis.

A mesh must cover every rank: JAX takes the first n devices, but a rank
outside the mesh would have nothing to run.

Draws. A sharded call must draw what the unsharded call draws, so that a
seed gives one result whatever the layout (JAX's global keys do that): each
rank's generator is wrapped in a :class:`ShardedGenerator`, and every
per-row draw of the port (dropout masks, TTA matrices, noise, the rater, the
diffusion times, the SSN and prob-U-Net normals) goes through
:func:`draw_rows`, which draws at the global shape from the one seeded
generator and keeps this rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .distributed import process_info

AXES = ("data", "member")


class Mesh:
    """The ranks laid out on ``shape`` over ``axis_names``; ``shape`` maps
    each axis to its size (as a JAX mesh's does), ``devices`` holds the ranks."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...] = AXES):
        rank, world = process_info()
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} ranks, the process "
                             f"group has {world}: a mesh covers every rank")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, shape))
        self.devices = np.arange(world).reshape(shape)
        self._coord = dict(zip(axis_names, (int(c) for c in np.argwhere(self.devices == rank)[0])))
        self._groups: dict[str, object] = {}
        # every rank creates every group, in one order, as new_group requires
        for a, name in enumerate(axis_names):
            if shape[a] == 1:
                continue
            lines = np.moveaxis(self.devices, a, -1).reshape(-1, shape[a])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    self._groups[name] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self._coord[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None when
        the axis has size 1)."""
        return self._groups.get(axis)

    def rows(self, n: int, axis: str) -> slice:
        """This rank's contiguous share of ``n`` rows split over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} rows do not split over the mesh's {axis} axis of {size}")
        per = n // size
        return slice(self.coord(axis) * per, (self.coord(axis) + 1) * per)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank coordinates {self._coord})"


def make_mesh(shape: tuple[int, ...] | None = None, axis_names: tuple[str, ...] = AXES) -> Mesh:
    """The mesh of every rank; by default all on the data axis."""
    if shape is None:
        shape = (process_info()[1],) + (1,) * (len(axis_names) - 1)
    return Mesh(tuple(shape), axis_names)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the mesh: its leading dimension split over
    ``axis``, or (``axis`` None) whole on every rank."""

    mesh: Mesh
    ndim: int | None = None
    axis: str | None = None

    def local(self, x):
        """This rank's part of ``x``."""
        if self.ndim is not None and x.ndim != self.ndim:
            raise ValueError(f"a {self.ndim}-d sharding got a {x.ndim}-d array")
        return x if self.axis is None else x[self.mesh.rows(x.shape[0], self.axis)]


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> Sharding:
    """The leading (batch) dimension split over ``axis``, the rest whole."""
    return Sharding(mesh, ndim, axis)


def member_sharding(mesh: Mesh, ndim: int, axis: str = "member") -> Sharding:
    """The leading (member) dimension of a stacked leaf split over ``axis``."""
    return Sharding(mesh, ndim, axis)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's rows of every array leaf (ndim >= 1) of a batch dict."""
    return {k: batch_sharding(mesh, v.ndim, axis).local(v)
            if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}


def replicate(tree: dict, mesh: Mesh) -> dict:
    """Every tensor of ``tree`` made equal on all ranks: rank 0's values,
    broadcast in place."""
    if mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1:
        for v in tree.values():
            if isinstance(v, torch.Tensor):
                dist.broadcast(v.data, src=0)
    return tree


def shard_member_stack(tree: dict, mesh: Mesh, axis: str = "member") -> dict:
    """This rank's slice of every (M, ...) leaf of a stacked state dict."""
    return {k: member_sharding(mesh, v.ndim, axis).local(v) for k, v in tree.items()}


def gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank along ``axis``, concatenated on ``dim`` in the
    axis's order (``all_gather_into_tensor``)."""
    group = mesh.group(axis)
    if group is None:
        return x
    part = x.movedim(dim, 0).contiguous()
    out = torch.empty((part.shape[0] * mesh.size(axis),) + part.shape[1:], dtype=part.dtype,
                      device=part.device)
    dist.all_gather_into_tensor(out, part, group=group)
    return out.movedim(0, dim)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the gradients the same
    way (every rank's loss depends on every rank's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (``x`` itself when None)."""
    return x if group is None else _AllReduceSum.apply(x, group)


class ShardedGenerator:
    """A rank's generator in a sharded call: per-row draws (:func:`draw_rows`)
    are drawn at the global shape from ``generator`` and this rank keeps its
    rows. ``images`` is the rank's image count (the innermost part of a
    row's index); ``data`` and ``member`` are this rank's (coordinate, size)
    of the axes its rows split over: a row's global index is
    ``((member-block, in-block row), data, image)`` major to minor."""

    def __init__(self, generator: torch.Generator, images: int,
                 data: tuple[int, int] = (0, 1), member: tuple[int, int] = (0, 1)):
        self.generator, self.images, self.data, self.member = generator, images, data, member

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)


def draw_rows(draw: Callable[[int, torch.Generator], torch.Tensor], rows: int, generator,
              axis: int = 0) -> torch.Tensor:
    """``draw(n, generator)`` gives a tensor with ``n`` rows on ``axis``.
    With a plain generator this is ``draw(rows, generator)``; with a
    :class:`ShardedGenerator` the global ``rows * data * member`` rows are
    drawn and this rank's ``rows`` kept: member-major blocks, the data axis
    next, each rank's ``images`` innermost."""
    if not isinstance(generator, ShardedGenerator):
        return draw(rows, generator)
    (d, nd), (m, nm), b = generator.data, generator.member, generator.images
    if rows % b:
        raise ValueError(f"a sharded draw of {rows} rows is not a whole number of rounds of "
                         f"the rank's {b} images")
    full = draw(rows * nd * nm, generator.generator).movedim(axis, 0)
    mine = full.reshape((nm, rows // b, nd, b) + full.shape[1:])[m, :, d]
    return mine.reshape((rows,) + full.shape[1:]).movedim(0, axis)
