"""The port's checkpoints (port of ``instsearch_tpu/utils/checkpoint.py``):
``save_pytree`` / ``load_pytree`` for backbone variables and
``save_sharded_pytree`` / ``load_sharded_pytree`` for stores that lie in row
shards.

A ``save_pytree`` checkpoint is a directory holding ``torch_weights.pt``,
the file name ``Index.save`` gives the backbone's state_dict, written by
``torch.save`` and read back with ``weights_only=True``. The reference
writes the same trees as orbax checkpoints, which the port does not read:
``tools/orbax_to_port.py`` converts them where JAX and orbax are installed.

A sharded tree is a directory holding one ``.npy`` file per leaf and
``tree.json``, the leaves' names, shapes and dtypes. A bf16 leaf is written
as its ``uint16`` bits (numpy has no bf16) and comes back as bf16. A leaf is
a tensor (or numpy array), or a :class:`Placed` leaf: one tensor per local
shard of a ``ShardMesh``, cut along one dim, as a placed ``Index`` holds its
store. Each shard writes its own rows from its own device into the file at
its offset (through a memory map opened for that shard alone), and a placed
load reads each local shard's rows from a read-only memory map and moves
them straight to that shard's device: no whole-leaf host buffer is made
either way. Across processes (a mesh with a ``torch.distributed`` group)
rank 0 creates the files, every process writes only its own shards, and
rank 0 writes ``tree.json`` last; rows are process-major, as in
``parallel/mesh.py``. The reference cannot read this form.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

WEIGHTS_FILE = "torch_weights.pt"
TREE_FILE = "tree.json"
TREE_FORMAT = "instsearch_torch.sharded_tree"
CONVERTER = "tools/orbax_to_port.py"
# a whole (unplaced) leaf goes to its file in pieces of at most this many
# bytes, so a store on the card is never copied to the host whole
_WRITE_PIECE = 64 << 20


def save_pytree(path: str, tree: Mapping[str, torch.Tensor]) -> None:
    """Write ``tree`` (a state_dict) to the directory ``path``, its tensors
    moved to the CPU."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in tree.items()},
               os.path.join(path, WEIGHTS_FILE))


def load_pytree(path: str) -> dict:
    """The state_dict :func:`save_pytree` wrote to ``path``, on the CPU;
    raises ``NotImplementedError`` for anything else (an orbax tree, which
    ``tools/orbax_to_port.py`` converts)."""
    weights = os.path.join(path, WEIGHTS_FILE)
    if not os.path.isfile(weights):
        raise NotImplementedError(
            f"{path} holds no {WEIGHTS_FILE}: an orbax weight tree written "
            f"by the JAX package must first be converted by {CONVERTER} "
            f"(run where JAX and orbax are installed)")
    return torch.load(weights, map_location="cpu", weights_only=True)


@dataclass(frozen=True)
class Placed:
    """A leaf held in shards: ``parts``, one tensor per local shard of
    ``mesh`` (equal shapes, each on its shard's device), cut along ``dim``.
    ``mesh`` None means one process holding every shard."""
    parts: Sequence[torch.Tensor]
    dim: int = 0
    mesh: Any = None


def _barrier(mesh) -> None:
    if mesh is not None and mesh.group is not None:
        import torch.distributed as dist
        dist.barrier(group=mesh.group)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as numpy, a bf16 tensor as its ``uint16`` bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tensor_of(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor of a leaf's numpy rows ``a`` stored as ``dtype`` (bf16
    rows are their ``uint16`` bits); ``a`` is copied only where it is not
    contiguous and writable."""
    a = np.require(a, requirements=["C", "W"])
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np_dtype(name: str) -> np.dtype:
    """numpy's dtype of a leaf stored as ``name`` (bf16 as its bits)."""
    if name == "bfloat16":
        return np.dtype(np.uint16)
    return torch.empty(0, dtype=getattr(torch, name)).numpy().dtype


def _create(path: str, dtype: np.dtype, shape) -> None:
    """A leaf's ``.npy`` file: its header, and the file grown to its size,
    without mapping it."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": np.lib.format.dtype_to_descr(dtype),
            "fortran_order": False, "shape": tuple(shape)})
        f.truncate(f.tell() + int(np.prod(shape)) * dtype.itemsize)


def _header(path: str) -> tuple:
    """(the data's offset, dtype, shape) of the ``.npy`` file at ``path``;
    ``ValueError`` for a file shorter than its header says."""
    with open(path, "rb") as f:
        major, _ = np.lib.format.read_magic(f)
        read = {1: np.lib.format.read_array_header_1_0,
                2: np.lib.format.read_array_header_2_0}.get(major)
        if read is None:
            raise ValueError(f"{path}: .npy version {major} is not read")
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if fortran or os.path.getsize(path) < offset + int(
            np.prod(shape)) * dtype.itemsize:
        raise ValueError(f"{path} is shorter than its {dtype}{list(shape)} "
                         f"array, or not in C order")
    return offset, dtype, shape


def _memmap(path: str, mode: str, region=None) -> np.memmap:
    """The one place a leaf's file is mapped, "r" to read or "r+" to
    write: only the rows ``region`` = (dim, lo, hi), [lo, hi) along
    ``dim``, where they lie in one piece of the file (every dim before
    ``dim`` of size 1), since a mapping's pages count as the process's
    memory while it lasts; else the whole array, cut to the region."""
    offset, dtype, shape = _header(path)
    if region is None:
        return np.memmap(path, dtype, mode, offset, shape)
    dim, lo, hi = region
    if all(n == 1 for n in shape[:dim]):
        step = int(np.prod(shape[dim + 1:])) * dtype.itemsize
        return np.memmap(path, dtype, mode, offset + lo * step,
                         shape[:dim] + (hi - lo,) + shape[dim + 1:])
    return np.memmap(path, dtype, mode, offset, shape)[_region(dim, lo, hi)]


def _region(dim: int, lo: int, hi: int) -> tuple:
    return (slice(None),) * dim + (slice(lo, hi),)


def _key_region(key, shape) -> "tuple | None":
    """The (dim, lo, hi) that ``key`` selects, a slice of consecutive rows
    along one dim (``slice(lo, hi)`` along dim 0, or ``(slice(None),) *
    dim + (slice(lo, hi),)``), or None for the whole array (``...``)."""
    if key is Ellipsis:
        return None
    key = key if isinstance(key, tuple) else (key,)
    dim = len(key) - 1
    if not all(isinstance(k, slice) for k in key) or any(
            k != slice(None) for k in key[:-1]):
        raise TypeError(f"a leaf is read by a slice of rows, not {key!r}")
    lo, hi, stride = key[-1].indices(shape[dim])
    if stride != 1:
        raise TypeError(f"a leaf is read by consecutive rows, not {key!r}")
    return dim, lo, max(lo, hi)


def _write(path: str, t: torch.Tensor, dim: int, offset: int) -> None:
    """Write ``t`` into the leaf file at ``offset`` along ``dim``, the file
    mapped over these rows alone and unmapped after: a tensor on a device
    comes to the host in pieces of at most ``_WRITE_PIECE`` bytes."""
    if t.dim() == 0:
        mm = _memmap(path, "r+")
        mm[...] = _host(t)
        mm.flush()
        return
    n = t.shape[dim]
    row_bytes = max(1, t.numel() * t.element_size() // max(n, 1))
    step = max(1, _WRITE_PIECE // row_bytes) if t.device.type != "cpu" else n
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        piece = _host(t.narrow(dim, lo, hi - lo))
        mm = _memmap(path, "r+", (dim, offset + lo, offset + hi))
        mm[...] = piece
        mm.flush()
        del mm, piece


def save_sharded_pytree(path: str, tree: Mapping[str, Any]) -> None:
    """Write ``tree`` (name -> tensor, numpy array or :class:`Placed`) to the
    directory ``path``: one ``<name>.npy`` a leaf and ``tree.json``. A
    placed leaf's shards each write their own rows at their offset; with a
    process group (its mesh's), rank 0 creates the files, a barrier
    follows, each process writes its own shards, a second barrier, and rank
    0 writes ``tree.json`` (whole leaves are rank 0's to write)."""
    os.makedirs(path, exist_ok=True)
    meshes = [v.mesh for v in tree.values() if isinstance(v, Placed)
              and v.mesh is not None and v.mesh.group is not None]
    group_mesh = meshes[0] if meshes else None
    rank = group_mesh.rank if group_mesh is not None else 0
    leaves, plan = {}, {}
    for name, v in tree.items():
        if os.sep in name or name in ("", ".", ".."):
            raise ValueError(f"leaf name {name!r} is not a file name")
        if isinstance(v, Placed):
            total = v.mesh.num_shards if v.mesh is not None else len(v.parts)
            shape = list(v.parts[0].shape)
            shape[v.dim] *= total
            dtype = _dtype_name(v.parts[0])
        else:
            v = torch.as_tensor(v)
            shape, dtype = list(v.shape), _dtype_name(v)
        np_dtype = _np_dtype(dtype)
        file = os.path.join(path, f"{name}.npy")
        leaves[name] = {"file": f"{name}.npy", "shape": shape,
                        "dtype": dtype}
        plan[name] = (file, v, np_dtype, shape)
    if rank == 0:
        stale = os.path.join(path, TREE_FILE)
        if os.path.exists(stale):
            os.remove(stale)
        for file, _, np_dtype, shape in plan.values():
            _create(file, np_dtype, shape)
    _barrier(group_mesh)
    for name, (file, v, _, _) in plan.items():
        if isinstance(v, Placed):
            first = v.mesh.first_shard if v.mesh is not None else 0
            c = v.parts[0].shape[v.dim]
            for j, part in enumerate(v.parts):
                _write(file, part, v.dim, (first + j) * c)
        elif rank == 0:
            _write(file, v, 0, 0)
    _barrier(group_mesh)
    if rank == 0:
        with open(os.path.join(path, TREE_FILE), "w") as f:
            json.dump({"format": TREE_FORMAT, "leaves": leaves}, f)
    _barrier(group_mesh)


class Leaf:
    """One leaf of a sharded tree, read on demand: ``shape``, ``dtype``
    (the stored dtype's name) and ``leaf[key]``, a numpy copy of the rows
    ``key`` selects (``...``, or consecutive rows along one dim), read
    through a read-only memory map of those rows opened for that read
    alone (bf16 rows as their ``uint16`` bits; :func:`tensor_of`)."""

    def __init__(self, file: str, shape, dtype: str):
        self.file, self.shape, self.dtype = file, tuple(shape), dtype

    def __getitem__(self, key) -> np.ndarray:
        region = _key_region(key, self.shape)
        if region is not None and region[2] == region[1]:
            shape = list(self.shape)
            shape[region[0]] = 0
            return np.empty(shape, _np_dtype(self.dtype))
        mm = _memmap(self.file, "r", region)
        out = np.array(mm[...])
        del mm
        return out

    def tensor(self, key=...) -> torch.Tensor:
        return tensor_of(self[key], self.dtype)


def open_tree(path: str) -> dict:
    """name -> :class:`Leaf` of the sharded tree at ``path``. Raises
    ``FileNotFoundError`` when the tree or a leaf's file is missing and
    ``ValueError`` when a file's shape or dtype is not the recorded one:
    a broken tree never falls back to another form."""
    tree_file = os.path.join(path, TREE_FILE)
    if not os.path.isfile(tree_file):
        raise FileNotFoundError(f"{path} holds no {TREE_FILE}: not a "
                                f"sharded tree, or its save did not finish")
    with open(tree_file) as f:
        meta = json.load(f)
    if meta.get("format") != TREE_FORMAT:
        raise ValueError(f"{tree_file}: format {meta.get('format')!r}, "
                         f"expected {TREE_FORMAT!r}")
    out = {}
    for name, rec in meta["leaves"].items():
        file = os.path.join(path, rec["file"])
        if not os.path.isfile(file):
            raise FileNotFoundError(f"{file}: leaf {name!r} of {path} is "
                                    f"missing")
        _, dtype, shape = _header(file)
        if shape != tuple(rec["shape"]) or dtype != _np_dtype(rec["dtype"]):
            raise ValueError(f"{file} holds {dtype}{list(shape)}, the tree "
                             f"records {rec['dtype']}{rec['shape']}")
        out[name] = Leaf(file, rec["shape"], rec["dtype"])
    return out


def _shard_range(n: int, mesh, j: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of ``n`` that local shard ``j`` of ``mesh`` holds
    (process-major: this process's first global shard is
    ``mesh.first_shard``)."""
    if n % mesh.num_shards:
        raise ValueError(f"{n} rows do not divide among {mesh.num_shards} "
                         f"shards")
    c = n // mesh.num_shards
    g = mesh.first_shard + j
    return g * c, (g + 1) * c


def load_sharded_pytree(path: str,
                        placements: Optional[Mapping[str, Any]] = None
                        ) -> dict:
    """The tree :func:`save_sharded_pytree` wrote to ``path``. Its
    ``placements`` stand for the reference's JAX ``shardings`` by design.
    ``placements`` maps a leaf's name to ``(mesh, dim)`` or None (a name it
    lacks is None): a placed leaf comes back as one tensor per local shard
    of ``mesh``, each shard's rows along ``dim`` read from the file alone
    and moved straight to its device (with a process group, this
    process's shards only); any other leaf whole, on the CPU."""
    placements = placements or {}
    out = {}
    for name, leaf in open_tree(path).items():
        where = placements.get(name)
        if where is None:
            out[name] = leaf.tensor()
            continue
        mesh, dim = where
        parts = []
        for j, dev in enumerate(mesh.devices):
            lo, hi = _shard_range(leaf.shape[dim], mesh, j)
            parts.append(leaf.tensor(_region(dim, lo, hi)).to(dev))
        out[name] = parts
    return out
