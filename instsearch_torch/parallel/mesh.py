"""The shard mesh (port of ``instsearch_tpu/parallel/mesh.py``: ``make_mesh``,
``shard_rows``, ``replicate``; the 1-D ``'shard'`` axis only).

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
