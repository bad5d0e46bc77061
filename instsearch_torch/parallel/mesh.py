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

A 2-D mesh over a process group (:func:`make_device_mesh` with ``group``)
lays the processes' devices out as the reference lays out
``jax.devices()``: the global list is rank 0's local devices, then rank
1's, and so on, reshaped row-major to the mesh's shape. So each process
holds whole rows, or each row spans whole processes; a process keeps only
its own block of the grid. Each line of either axis (a row, a column) has
the ``torch.distributed`` subgroup of the processes that hold it, made once
when the mesh is made; a model-parallel runtime runs its collectives over
it (:func:`axis_groups`).
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
        return gather_parts(self.devices[0], self.group, parts, dim)


def gather_parts(device, group, parts: Sequence[torch.Tensor], dim: int
                 ) -> torch.Tensor:
    """``parts`` joined along ``dim`` on ``device``; with ``group``, one
    ``all_gather`` then joins every process's join in rank order (equal
    shapes on every process)."""
    local = torch.cat([p.to(device) for p in parts], dim)
    if group is None:
        return local
    import torch.distributed as dist
    local = local.contiguous()
    out = [torch.empty_like(local)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, local, group=group)
    return torch.cat(out, dim)


class AxisGroup(tuple):
    """The devices this process holds on one line of a mesh axis, in axis
    order (a tuple, equal to the plain tuple of them), and where the line
    lies: ``line``, its position along the mesh's other axis (0 on a 1-D
    mesh); ``start``, the axis position of its first device; ``size``, the
    line's length over every process; ``group``, the ``torch.distributed``
    group of the processes that hold the line, in axis order (None when the
    mesh has no group: this process holds all of it)."""

    def __new__(cls, devices, line: int = 0, start: int = 0,
                size: "int | None" = None, group=None):
        self = super().__new__(cls, devices)
        self.line, self.start, self.group = line, start, group
        self.size = len(self) if size is None else size
        return self

    def with_devices(self, devices) -> "AxisGroup":
        """The same line over other names of its devices."""
        return AxisGroup(devices, self.line, self.start, self.size,
                         self.group)

    def gather(self, parts: Sequence[torch.Tensor], dim: int
               ) -> torch.Tensor:
        """The local devices' ``parts`` joined along ``dim`` in axis order
        on the first device, on every process of the line
        (:func:`gather_parts`)."""
        return gather_parts(self[0], self.group, parts, dim)

    def global_rank(self, index: int) -> int:
        """The global rank of the line's ``index``-th process."""
        import torch.distributed as dist
        return dist.get_global_rank(self.group, index)


@dataclass(frozen=True)
class DeviceMesh:
    """A 2-D mesh: ``devices[i][j]`` is the torch device at position
    ``(origin[0] + i, origin[1] + j)`` of the axes ``axis_names`` (devices
    may repeat). In one process (``group`` None) ``devices`` is the whole
    grid. Over a process group (:func:`make_device_mesh`) it is this
    process's block of the ``dims`` grid, and ``line_groups[a][p]`` is the
    subgroup of the processes that hold the line along axis ``a`` at
    position ``p`` of the other axis."""
    devices: tuple
    axis_names: tuple
    group: object = None
    dims: "tuple | None" = None
    origin: tuple = (0, 0)
    line_groups: tuple = ((), ())

    @property
    def shape(self) -> dict:
        dims = self.dims or (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axis_names, dims))

    def along(self, axis: str) -> ShardMesh:
        """The 1-D mesh along ``axis`` through this process's first device
        (position 0 of the other axis in one process), with its line's
        subgroup: the devices a stage over ``axis`` uses (the reference
        replicates the stage over the other axis; one process needs one
        replica)."""
        line = axis_groups(self, axis)[0]
        return ShardMesh(tuple(line), line.group, axis)


def axis_groups(mesh, axis: str) -> list[AxisGroup]:
    """The lines along ``axis`` that this process holds, in order of their
    position along the mesh's other axis (one line on a 1-D mesh), each
    the devices this process holds on it with its subgroup
    (:class:`AxisGroup`): the groups a model-parallel runtime
    (``parallel/tp.py``, ``pp.py``, ``sp.py``) splits one replica over,
    the other axis carrying the batch. On a mesh with a process group the
    runtime's collectives run over each line's group; in one process the
    devices' tensors move by ``.to()``."""
    if isinstance(mesh, ShardMesh):
        mesh.along(axis)
        return [AxisGroup(mesh.devices, 0, mesh.first_shard,
                          mesh.num_shards, mesh.group)]
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names}, not {axis!r}")
    a = mesh.axis_names.index(axis)
    size = mesh.shape[axis]
    lines = (tuple(zip(*mesh.devices)) if a == 0 else
             tuple(tuple(row) for row in mesh.devices))
    first = mesh.origin[1 - a]
    return [AxisGroup(devs, first + p, mesh.origin[a], size,
                      mesh.line_groups[a][first + p]
                      if mesh.group is not None else None)
            for p, devs in enumerate(lines)]


def batch_groups(mesh, axis: str, data_axis: "str | None"
                 ) -> tuple[list, int, "ShardMesh | None"]:
    """How a runtime over ``axis`` whose batch goes over ``data_axis``
    (``'data'`` when None and the mesh has one) cuts its batch:
    ``(lines, n_data, data_mesh)``. ``lines`` are ``(position, line)``
    pairs, the ``axis_groups`` this process runs with the data position
    whose share of the batch each takes, of ``n_data`` equal shares;
    ``data_mesh`` is the data axis's 1-D mesh, whose ``gather(outs, 0)``
    joins the lines' outputs in batch order on every process. Without a
    data axis every line would compute the whole batch: one line runs it
    (``n_data`` 1, ``data_mesh`` None)."""
    groups = axis_groups(mesh, axis)
    if data_axis is None and "data" in mesh.axis_names:
        data_axis = "data"
    if data_axis is None:
        return [(0, groups[0])], 1, None
    if data_axis == axis or data_axis not in mesh.axis_names:
        raise ValueError(f"data axis {data_axis!r}: mesh axes "
                         f"{mesh.axis_names}, model axis {axis!r}")
    return ([(g.line, g) for g in groups], mesh.shape[data_axis],
            mesh.along(data_axis))


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
    """A mesh of ``num_shards`` shards. Its signature differs from the
    reference's ``make_mesh(num_devices, axis)`` by design: a torch mesh
    is given its devices and process group, which JAX takes from
    ``jax.devices()``, and its one axis is always ``'shard'``. Without
    ``devices``, one shard on
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


def make_device_mesh(shape: tuple, axis_names: tuple,
                     devices: "Sequence[torch.device | str] | None" = None,
                     group=None) -> DeviceMesh:
    """A 2-D mesh of ``shape`` ``(rows, cols)`` over the axes
    ``axis_names``. In one process ``devices`` (row-major, ``rows * cols``
    of them, may repeat) default to the first visible CUDA devices, raising
    when there are too few. With a ``torch.distributed`` ``group``,
    ``devices`` are this process's (required), every process of the group
    gives as many, and the mesh is their process-major list reshaped
    row-major, as the reference reshapes ``jax.devices()``; a process must
    hold whole rows or a row whole processes. Every process of the group
    (every process of the default group, which ``new_group`` needs) must
    make the mesh, in the same order as its other meshes: it makes each
    row's and each column's subgroup."""
    rows, cols = shape
    if group is not None:
        return _process_grid(rows, cols, devices, tuple(axis_names), group)
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
                            for i in range(rows)), tuple(axis_names))


def _process_grid(rows: int, cols: int, devices, names: tuple, group
                  ) -> DeviceMesh:
    import torch.distributed as dist
    if devices is None:
        raise ValueError("a mesh over a process group needs this "
                         "process's devices=")
    devs = [torch.device(d) for d in devices]
    n, world = len(devs), dist.get_world_size(group)
    if rows < 1 or cols < 1 or not devs or rows * cols != world * n:
        raise ValueError(f"a {rows}x{cols} mesh needs {rows * cols} devices, "
                         f"{world} processes of {n} give {world * n}")
    if n % cols and cols % n:
        raise ValueError(f"a process's {n} devices neither hold whole "
                         f"rows of {cols} nor split a row evenly")
    ranks = dist.get_process_group_ranks(group)

    def owner(i, k):
        return ranks[(i * cols + k) // n]

    # every process makes every line's subgroup, in one order
    row_groups = tuple(dist.new_group(sorted({owner(i, k)
                                              for k in range(cols)}))
                       for i in range(rows))
    col_groups = tuple(dist.new_group(sorted({owner(i, k)
                                              for i in range(rows)}))
                       for k in range(cols))
    w = min(n, cols)
    origin = divmod(dist.get_rank(group) * n, cols)
    return DeviceMesh(tuple(tuple(devs[i * w:(i + 1) * w])
                            for i in range(n // w)), names, group,
                      (rows, cols), origin, (col_groups, row_groups))


def make_mesh_2d(data: int, shard: int,
                 *, devices: "Sequence[torch.device | str] | None" = None,
                 group=None) -> DeviceMesh:
    """A ``('data', 'shard')`` mesh: data-parallel extraction over
    ``'data'``, the index's rows over ``'shard'`` (:func:`make_device_mesh`:
    ``devices`` and ``group``)."""
    return make_device_mesh((data, shard), ("data", "shard"), devices, group)


def make_mesh_dp_tp(data: int, model: int,
                    *, devices: "Sequence[torch.device | str] | None" = None,
                    group=None) -> DeviceMesh:
    """A ``('data', 'model')`` mesh: the batch over ``'data'``, the ViT's
    tensor-parallel weight split over ``'model'`` (innermost, as the
    reference; :func:`make_device_mesh`: ``devices`` and ``group``)."""
    return make_device_mesh((data, model), ("data", "model"), devices, group)


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


def shard_rows(mesh: ShardMesh, x: torch.Tensor, *, dim: int = 0
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
