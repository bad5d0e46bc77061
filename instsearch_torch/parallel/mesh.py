"""The device meshes (port of ``instsearch_tpu/parallel/mesh.py``:
``make_mesh``, ``default_data_mesh``, ``make_mesh_2d``, ``make_mesh_dp_tp``,
``shard_rows``, ``replicate``).

In the reference one process drives a ``jax.sharding.Mesh`` through
``shard_map``. Here a :class:`ShardMesh` names the torch device of each
shard this process holds, in shard order, and optionally a
``torch.distributed`` process group for the shards other processes hold.
Global shard ``g`` of process ``rank`` is its local shard ``g - rank *
len(devices)``: rows are process-major, as in the reference's multi-host
layout.

Devices may repeat: eight shards on ``cuda:0`` run the published 8-shard
layout on one card (and ``["cpu"] * 8`` on the CPU, the counterpart of the
reference tests' eight virtual devices); each shard then launches its own
kernels, serially. A shard is a row slice of the store: on the store's own
device it is a view, never a copy.

The cross-shard step, the reference's all-gather over ICI, is
:meth:`ShardMesh.gather`: the local shards' pieces move to the first device
and are concatenated in shard order; with a group, one
``torch.distributed.all_gather`` then joins the processes' pieces in rank
order (gloo on the CPU, NCCL on the card).

The 2-D meshes (:class:`DeviceMesh`) name a device at each position of two
axes, ``('data', 'shard')`` or ``('data', 'model')``, as the reference's
``Mesh`` does. A stage takes the 1-D mesh along its own axis
(:meth:`DeviceMesh.along`): the sharded index its ``'shard'`` axis (else
the first), data-parallel extraction its ``'data'`` axis (else the first
that is not ``'model'``). A 1-D :class:`ShardMesh` names its one axis too
(``'shard'``, or ``'data'`` from :func:`default_data_mesh`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class ShardMesh:
    """``devices``: one torch device per local shard, in shard order;
    ``group``: the ``torch.distributed`` group of the processes that hold
    the other shards, or None when this process holds them all."""
    devices: tuple
    group: object = None
    axis: str = "shard"

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.num_shards}

    def along(self, axis: str) -> "ShardMesh":
        """The 1-D mesh along ``axis``: this one."""
        if axis != self.axis:
            raise ValueError(f"mesh axis {self.axis!r}, not {axis!r}")
        return self

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def num_local(self) -> int:
        return len(self.devices)

    @property
    def num_shards(self) -> int:
        return self.num_local * self.world

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.num_local

    def gather(self, parts: Sequence[torch.Tensor], dim: int = 1
               ) -> torch.Tensor:
        """The local shards' ``parts`` (one per shard, on its device, equal
        shapes) joined along ``dim`` in global shard order, on the first
        device, on every process."""
        local = torch.cat([p.to(self.devices[0]) for p in parts], dim)
        if self.group is None:
            return local
        import torch.distributed as dist
        local = local.contiguous()
        out = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(out, local, group=self.group)
        return torch.cat(out, dim)


@dataclass(frozen=True)
class DeviceMesh:
    """A 2-D mesh of one process: ``devices[i][j]`` is the torch device at
    position ``(i, j)`` of the axes ``axis_names`` (devices may repeat)."""
    devices: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def along(self, axis: str) -> ShardMesh:
        """The 1-D mesh along ``axis``, at position 0 of the other axis:
        the devices a stage over ``axis`` uses (the reference replicates
        the stage over the other axis; one process needs one replica)."""
        if axis == self.axis_names[0]:
            devs = tuple(row[0] for row in self.devices)
        elif axis == self.axis_names[1]:
            devs = tuple(self.devices[0])
        else:
            raise ValueError(f"mesh axes {self.axis_names}, not {axis!r}")
        return ShardMesh(devs, axis=axis)


def axis_groups(mesh, axis: str) -> list[tuple]:
    """The devices along ``axis`` at each position of the mesh's other axis,
    in order (one group on a 1-D mesh): the groups a model-parallel runtime
    (``parallel/tp.py``, ``pp.py``, ``sp.py``) splits one replica over,
    the other axis carrying the batch. These runtimes run in one process:
    a mesh with a process group raises ``ValueError``."""
    if isinstance(mesh, ShardMesh):
        if mesh.group is not None:
            raise ValueError(f"the {axis!r} axis runs in one process; this "
                             f"mesh spans a process group")
        mesh.along(axis)
        return [mesh.devices]
    if axis == mesh.axis_names[1]:
        return [tuple(row) for row in mesh.devices]
    if axis == mesh.axis_names[0]:
        return [tuple(row[j] for row in mesh.devices)
                for j in range(len(mesh.devices[0]))]
    raise ValueError(f"mesh axes {mesh.axis_names}, not {axis!r}")


def batch_groups(mesh, axis: str, data_axis: "str | None") -> list[tuple]:
    """``axis_groups`` of a runtime whose batch goes over ``data_axis``
    (``'data'`` when None and the mesh has one; none at all, so one group,
    otherwise)."""
    groups = axis_groups(mesh, axis)
    if data_axis is None and "data" in mesh.axis_names:
        data_axis = "data"
    if data_axis is None:
        return groups[:1]
    if data_axis == axis or data_axis not in mesh.axis_names:
        raise ValueError(f"data axis {data_axis!r}: mesh axes "
                         f"{mesh.axis_names}, model axis {axis!r}")
    return groups


def shard_axis(mesh) -> str:
    """The axis rows shard over: ``'shard'``, else the mesh's first."""
    return "shard" if "shard" in mesh.axis_names else mesh.axis_names[0]


def batch_axis(mesh) -> "str | None":
    """The data-parallel axis: ``'data'``, else the first axis that is not
    ``'model'`` (a tensor-parallel axis is never a batch axis), else None."""
    if "data" in mesh.axis_names:
        return "data"
    return next((a for a in mesh.axis_names if a != "model"), None)


def as_shard_mesh(mesh) -> ShardMesh:
    """A mesh's 1-D mesh along its shard axis (a :class:`ShardMesh` is its
    own)."""
    return mesh if isinstance(mesh, ShardMesh) else mesh.along(
        shard_axis(mesh))


def _visible_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(num_shards: "int | None" = None,
              devices: "Sequence[torch.device | str] | None" = None,
              group=None) -> ShardMesh:
    """A mesh of ``num_shards`` shards. Without ``devices``, one shard on
    each of the first ``num_shards`` visible CUDA devices (all of them when
    ``num_shards`` is None); raises when it exceeds their count, as the
    reference's ``make_mesh`` does, so it never shrinks silently. With
    ``devices`` (which may repeat, e.g. ``["cuda"] * 8`` or ``["cpu"] *
    8``), one local shard on each; ``num_shards``, when given, must equal
    their count times the group's processes."""
    if devices is None:
        visible = _visible_devices()
        n = num_shards or len(visible)
        if not visible or n > len(visible):
            raise ValueError(
                f"requested {n} shards, have {len(visible)} CUDA devices; "
                f"pass devices= to place several shards on one device (or "
                f"on the CPU)")
        devices = visible[:n]
    mesh = ShardMesh(tuple(torch.device(d) for d in devices), group)
    if not mesh.devices:
        raise ValueError("a mesh needs at least one device")
    if num_shards is not None and num_shards != mesh.num_shards:
        raise ValueError(f"requested {num_shards} shards, the devices and "
                         f"group give {mesh.num_shards}")
    return mesh


def default_data_mesh() -> "ShardMesh | None":
    """The data-parallel mesh of ``Index.build`` and ``ResumableBuilder``:
    every visible CUDA device over ``'data'`` when there are more than one,
    else None (one device)."""
    visible = _visible_devices()
    if len(visible) <= 1:
        return None
    return ShardMesh(tuple(visible), axis="data")


def _grid(rows: int, cols: int, devices, names: tuple) -> DeviceMesh:
    if devices is None:
        visible = _visible_devices()
        if rows * cols > len(visible):
            raise ValueError(f"requested {rows}x{cols} devices, have "
                             f"{len(visible)} CUDA devices; pass devices=")
        devices = visible[:rows * cols]
    devs = [torch.device(d) for d in devices]
    if rows < 1 or cols < 1 or len(devs) != rows * cols:
        raise ValueError(f"a {rows}x{cols} mesh needs {rows * cols} devices, "
                         f"got {len(devs)}")
    return DeviceMesh(tuple(tuple(devs[i * cols:(i + 1) * cols])
                            for i in range(rows)), names)


def make_mesh_2d(data: int, shard: int,
                 devices: "Sequence[torch.device | str] | None" = None
                 ) -> DeviceMesh:
    """A ``('data', 'shard')`` mesh: data-parallel extraction over
    ``'data'``, the index's rows over ``'shard'``. ``devices`` (row-major,
    ``data * shard`` of them, may repeat) default to the first visible CUDA
    devices, raising when there are too few."""
    return _grid(data, shard, devices, ("data", "shard"))


def make_mesh_dp_tp(data: int, model: int,
                    devices: "Sequence[torch.device | str] | None" = None
                    ) -> DeviceMesh:
    """A ``('data', 'model')`` mesh: the batch over ``'data'``, the ViT's
    tensor-parallel weight split over ``'model'`` (innermost, as the
    reference)."""
    return _grid(data, model, devices, ("data", "model"))


def device_mesh(num_shards: int, device: "torch.device | str"
                ) -> ShardMesh:
    """A one-process mesh for an index on ``device``: ``num_shards`` shards
    (every visible card when it is 1 or less and ``device`` is one)
    dealt to the cards in turn, so fewer cards than shards hold several
    each; a CPU ``device`` holds every shard."""
    device = torch.device(device)
    visible = _visible_devices() if device.type == "cuda" else [device]
    n = num_shards if num_shards > 1 else len(visible)
    return make_mesh(n, devices=[visible[i % len(visible)]
                                 for i in range(n)])


def shard_rows(mesh: ShardMesh, x: torch.Tensor, dim: int = 0
               ) -> list[torch.Tensor]:
    """This process's rows of ``x`` (all of them in a single process) cut
    along ``dim`` into one equal slice per local shard, each on its
    shard's device: a view where the device is ``x``'s own."""
    n = x.shape[dim]
    if n % mesh.num_local:
        raise ValueError(f"{n} rows not divisible by {mesh.num_local} "
                         f"local shards")
    c = n // mesh.num_local
    return [x.narrow(dim, j * c, c).to(dev)
            for j, dev in enumerate(mesh.devices)]


def replicate(mesh: ShardMesh, x: torch.Tensor) -> list[torch.Tensor]:
    """``x`` on every local shard's device (the same tensor where it
    already lies there)."""
    return [x.to(dev) for dev in mesh.devices]
