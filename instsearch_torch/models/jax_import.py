"""Flax ResNet, VGG and ViT variables -> the port's state_dicts: the inverses
of ``instsearch_tpu/models/torch_import.py::load_torch_resnet``,
``load_torch_vgg`` and ``load_torch_vit``.

``variables`` is the reference's pytree of arrays (numpy or anything
``np.asarray`` takes): ``{"params": ..., "batch_stats": ...}`` for a ResNet,
``{"params": ...}`` for a VGG or a ViT. Conv kernels go from HWIO to OIHW
(a VGG's ``conv{idx}`` becomes ``features.{idx}``, torchvision's index), Dense
kernels from ``[in, out]`` to Linear's ``[out, in]``; LayerNorm and
BatchNorm ``scale`` becomes ``weight``, BatchNorm ``mean``/``var`` become
``running_mean``/``running_var``; the ViT's ``class_token`` and
``pos_embedding`` are carried as they are. Unknown or missing leaves raise,
as the importer does: a silently skipped layer would leave random weights
in the network.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
_VIT_MODULE = re.compile(
    r"conv_proj|ln|encoder_layer_\d+\.(ln_1|qkv|out|ln_2|linear_1|linear_2)")
_VIT_TOP = ("class_token", "pos_embedding")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in dict(tree).items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_name(path: tuple) -> str:
    name = ".".join(path)
    return (name.replace("downsample_conv", "downsample.0")
            .replace("downsample_bn", "downsample.1"))


def from_jax_resnet(variables: Mapping[str, Any],
                    model: "torch.nn.Module | None" = None) -> dict:
    """-> state_dict of torch tensors (f32 on the CPU). When ``model`` is
    given, the key set and every shape are checked against its own
    state_dict (``num_batches_tracked`` aside) and a mismatch raises."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    sd: dict = {}
    for coll, table in (("params", _PARAM_LEAF),
                        ("batch_stats", _STAT_LEAF)):
        for path, val in _flatten(variables.get(coll, {})).items():
            *mod, leaf = path
            if leaf not in table or not mod or not re.fullmatch(
                    r"conv\d|bn\d|downsample_conv|downsample_bn", mod[-1]):
                raise ValueError(f"unhandled {coll} leaf: {'/'.join(path)}")
            arr = np.asarray(val, np.float32)
            if leaf == "kernel":
                arr = arr.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            sd[f"{_torch_name(tuple(mod))}.{table[leaf]}"] = \
                torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        _check_fits(sd, model)
    return sd


def _check_fits(sd: dict, model: torch.nn.Module) -> None:
    """Raise unless ``sd`` has exactly the model's keys (BatchNorm's step
    counters aside) and shapes."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or bad:
        raise ValueError(f"variables do not fit the model: missing="
                         f"{missing[:5]} extra={extra[:5]} "
                         f"shape_mismatch={bad[:5]}")


def load_jax_resnet(model: torch.nn.Module, variables: Mapping) -> None:
    """Load Flax variables into ``model`` in place (checked, strict)."""
    sd = from_jax_resnet(variables, model)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    # the only keys the Flax tree lacks are BatchNorm's step counters
    left = [k for k in missing if not k.endswith("num_batches_tracked")]
    if left or unexpected:
        raise ValueError(f"load mismatch: missing={left[:5]} "
                         f"unexpected={unexpected[:5]}")


def from_jax_vit(variables: Mapping[str, Any],
                 model: "torch.nn.Module | None" = None) -> dict:
    """-> state_dict of torch tensors (f32 on the CPU) for ``models.vit.ViT``.
    When ``model`` is given, the key set and every shape are checked against
    its own state_dict and a mismatch raises."""
    unknown = set(variables) - {"params"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    sd: dict = {}
    for path, val in _flatten(variables.get("params", {})).items():
        arr = np.asarray(val, np.float32)
        *mod, leaf = path
        if not mod and leaf in _VIT_TOP:
            sd[leaf] = torch.from_numpy(np.ascontiguousarray(arr))
            continue
        name = ".".join(mod)
        if leaf not in _PARAM_LEAF or not _VIT_MODULE.fullmatch(name):
            raise ValueError(f"unhandled params leaf: {'/'.join(path)}")
        if leaf == "kernel":          # conv HWIO -> OIHW, Dense transposed
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        sd[f"{name}.{_PARAM_LEAF[leaf]}"] = torch.from_numpy(
            np.ascontiguousarray(arr))
    if model is not None:
        _check_fits(sd, model)
    return sd


def load_jax_vit(model: torch.nn.Module, variables: Mapping) -> None:
    """Load Flax ViT variables into ``model`` in place (checked, strict)."""
    model.load_state_dict(from_jax_vit(variables, model))


def from_jax_vgg(variables: Mapping[str, Any],
                 model: "torch.nn.Module | None" = None) -> dict:
    """-> state_dict of torch tensors (f32 on the CPU) for ``models.vgg.VGG``:
    Flax ``conv{idx}.kernel`` (HWIO) -> ``features.{idx}.weight`` (OIHW),
    ``conv{idx}.bias`` -> ``features.{idx}.bias``. When ``model`` is given,
    the key set and every shape are checked against its own state_dict and
    a mismatch raises."""
    unknown = set(variables) - {"params"}
    if unknown:
        raise ValueError(f"unknown variable collections: {sorted(unknown)}")
    sd: dict = {}
    for path, val in _flatten(variables.get("params", {})).items():
        m = (re.fullmatch(r"conv(\d+)", path[0])
             if len(path) == 2 and path[1] in ("kernel", "bias") else None)
        if m is None:
            raise ValueError(f"unhandled params leaf: {'/'.join(path)}")
        arr = np.asarray(val, np.float32)
        if path[1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        sd[f"features.{m.group(1)}.{_PARAM_LEAF[path[1]]}"] = \
            torch.from_numpy(np.array(arr, order="C"))       # a copy
    if model is not None:
        _check_fits(sd, model)
    return sd


def load_jax_vgg(model: torch.nn.Module, variables: Mapping) -> None:
    """Load Flax VGG variables into ``model`` in place (checked, strict)."""
    model.load_state_dict(from_jax_vgg(variables, model))
