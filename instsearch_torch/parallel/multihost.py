"""The multi-process form (port of ``instsearch_tpu/parallel/multihost.py``).

An index past one card's memory spans processes: each holds some shards
(``parallel/mesh.py``), and the shard axis extends across them through a
``torch.distributed`` group. The per-shard kernels are unchanged; the
candidate gathers become ``all_gather`` calls over gloo (CPU shards) or
NCCL (CUDA shards). Each process hands over only its own rows
(:func:`build_multihost_index`); the dataset ids stay host-global, so every
process can rank the whole store.

Rows are process-major: process p of P holds rows ``[p * N / P, (p + 1) *
N / P)`` (:func:`local_row_range`), its local shard j being global shard
``p * len(devices) + j``.

The 2-D meshes span processes the same way (:func:`global_mesh_2d`,
:func:`global_mesh_dp_tp`): data-parallel extraction (``Extractor``) and
the ViT's model-parallel forwards (``parallel/tp.py``, ``pp.py``,
``sp.py``) run over them with each process holding only its positions.
"""
from __future__ import annotations

import logging
import os
from typing import Sequence

import torch

from .mesh import (DeviceMesh, ShardMesh, make_mesh, make_mesh_2d,
                   make_mesh_dp_tp, shard_rows)

log = logging.getLogger("instsearch.multihost")

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _dist():
    import torch.distributed as dist
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    return dist


def initialize(backend: "str | None" = None) -> bool:
    """``torch.distributed.init_process_group`` from the usual environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; the
    ``env://`` method). A no-op in a single process, where the environment
    names no world (returns False); True once the group is up. The backend
    defaults to gloo for CPU tensors and, where CUDA and NCCL are both
    there, NCCL for CUDA tensors (``"cpu:gloo,cuda:nccl"``), so a mesh of
    either kind of shard gathers over it. Raises when the environment names
    a world that cannot be started: a variable missing, or no such
    backend."""
    if "WORLD_SIZE" not in os.environ:
        log.info("no WORLD_SIZE in the environment: single process")
        return False
    dist = _dist()
    if dist.is_initialized():
        return True
    missing = [v for v in _ENV if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE is set but {', '.join(missing)} "
                           f"{'is' if len(missing) == 1 else 'are'} not")
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   and dist.is_nccl_available() else "gloo")
    available = {"nccl": dist.is_nccl_available,
                 "gloo": dist.is_gloo_available}
    for name in (b.split(":")[-1] for b in backend.split(",")):
        if not available.get(name, lambda: True)():
            raise RuntimeError(f"backend {name!r} is not available in this "
                               f"PyTorch build")
    dist.init_process_group(backend=backend, init_method="env://")
    log.info("initialized process %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def global_shard_mesh(devices: "Sequence[torch.device | str]") -> ShardMesh:
    """This process's local shards, one on each of ``devices`` (which may
    repeat), joined to the other processes' through the default group when
    one is up; a single-process mesh otherwise."""
    return make_mesh(devices=devices, group=_world())


def _world():
    dist = _dist()
    return dist.group.WORLD if dist.is_initialized() else None


def global_mesh_2d(data: int, shard: int,
                   devices: "Sequence[torch.device | str]") -> DeviceMesh:
    """A ``('data', 'shard')`` mesh over every process of the default
    group, this process's positions on ``devices`` (``make_mesh_2d`` with
    its group); a single-process mesh when no group is up. Every process
    makes it, in the same order as its other meshes."""
    return make_mesh_2d(data, shard, devices, _world())


def global_mesh_dp_tp(data: int, model: int,
                      devices: "Sequence[torch.device | str]"
                      ) -> DeviceMesh:
    """A ``('data', 'model')`` mesh over every process of the default
    group (``make_mesh_dp_tp`` with its group), as
    :func:`global_mesh_2d`."""
    return make_mesh_dp_tp(data, model, devices, _world())


def local_row_range(n_rows: int) -> tuple[int, int]:
    """``[start, stop)`` of the global rows this process holds for a mesh
    over every process (:func:`global_shard_mesh`); the rows must divide
    evenly over the processes."""
    dist = _dist()
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    if n_rows % nproc:
        raise ValueError(f"{n_rows} rows not divisible by {nproc} processes")
    per = n_rows // nproc
    p = dist.get_rank() if dist.is_initialized() else 0
    return p * per, (p + 1) * per


def shard_local_rows(mesh: ShardMesh, local_rows, dim: int = 0
                     ) -> list[torch.Tensor]:
    """This process's rows (:func:`local_row_range`) split over its local
    shards, each on its device (``shard_rows``): no process ever holds
    the whole store."""
    return shard_rows(mesh, torch.as_tensor(local_rows), dim)


def build_multihost_index(local_descriptors, ids,
                          mesh: "ShardMesh | None" = None, local_scales=None,
                          local_regional=None, local_regional_scales=None,
                          **kw):
    """A :class:`ShardedIndex` over every process: ``local_descriptors``
    (this process's ``[N/P, W]`` rows), ``ids`` the dataset ids of all ``N``
    rows (identical on every process), ``local_scales`` this process's
    ``[1, N/P]`` row scales (int8, int4), ``local_regional`` /
    ``local_regional_scales`` its ``[N/P, R, D]`` / ``[N/P, R]`` slice of
    the re-rank store. ``mesh`` defaults to one shard on this process's
    CUDA device. ``kw`` goes to ``ShardedIndex``, whose route defaults to
    the kernels."""
    from ..utils.device import resolve_device
    from .sharded_index import ShardedIndex
    mesh = mesh or global_shard_mesh([resolve_device(None)])
    return ShardedIndex(local_descriptors, ids, mesh=mesh,
                        scales=local_scales, regional=local_regional,
                        regional_scales=local_regional_scales, **kw)
