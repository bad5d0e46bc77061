"""The port's checkpoint of backbone variables (port of
``instsearch_tpu/utils/checkpoint.py``: ``save_pytree`` and
``load_pytree``).

A checkpoint is a directory holding ``torch_weights.pt``, the file name
``Index.save`` gives the backbone's state_dict, written by ``torch.save``
and read back with ``weights_only=True``. The reference writes the same
trees as orbax checkpoints, which the port cannot read without JAX (ROADMAP
M10, the orbax reader); its sharded form (``save_sharded_pytree``) is not
ported (ROADMAP Queue 1): ``Index.load(mesh=)`` places the npz store
shard by shard instead."""
from __future__ import annotations

import os
from typing import Mapping

import torch

WEIGHTS_FILE = "torch_weights.pt"


def save_pytree(path: str, tree: Mapping[str, torch.Tensor]) -> None:
    """Write ``tree`` (a state_dict) to the directory ``path``, its tensors
    moved to the CPU."""
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in tree.items()},
               os.path.join(path, WEIGHTS_FILE))


def load_pytree(path: str) -> dict:
    """The state_dict :func:`save_pytree` wrote to ``path``, on the CPU;
    raises ``NotImplementedError`` for anything else (an orbax tree)."""
    weights = os.path.join(path, WEIGHTS_FILE)
    if not os.path.isfile(weights):
        raise NotImplementedError(
            f"{path} holds no {WEIGHTS_FILE}: an orbax weight tree needs the "
            f"orbax reader, which is not ported (ROADMAP M10)")
    return torch.load(weights, map_location="cpu", weights_only=True)
