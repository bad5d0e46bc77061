"""torch(vision) state_dict -> the port's own modules (port of
``instsearch_tpu/models/torch_import.py``, which maps the same checkpoints
onto the Flax backbones).

The port's ResNet and VGG keep torchvision's module names, so their
importers keep the backbone's keys as they are and drop the classifier
(``fc.*``, ``classifier.*``) and BatchNorm's ``num_batches_tracked``. The
ViT's torchvision names map onto the port's: ``encoder.layers.encoder_layer_
{i}.self_attention.in_proj_*`` -> ``encoder_layer_{i}.qkv.*`` (the packed
``[q; k; v]`` rows are the port's order), ``out_proj`` -> ``out``,
``mlp.{0,3}`` (or the older ``mlp.linear_{1,2}``) -> ``linear_{1,2}``,
``encoder.pos_embedding`` -> ``pos_embedding``, ``encoder.ln`` -> ``ln``;
the classifier (``heads.*``) is dropped. A key none of these rules takes
raises, as in the reference: a silently skipped layer would leave random
weights in the network.

Values may be torch tensors or numpy arrays, so a raw ``torch.load(...,
map_location="cpu")`` state_dict works directly (no torchvision needed);
the results are f32 CPU tensors, loaded by ``load_state_dict_checked``.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from .jax_import import _check_fits

_RESNET_KEY = re.compile(
    r"(layer\d\.\d+\.)?(conv\d|bn\d|downsample\.[01])\."
    r"(weight|bias|running_mean|running_var)")
_VGG_KEY = re.compile(r"features\.\d+\.(weight|bias)")
_VIT_LAYER = re.compile(r"encoder\.layers\.encoder_layer_(\d+)\.(.+)")
_VIT_MODULES = {"ln_1": "ln_1", "ln_2": "ln_2",
                "self_attention.out_proj": "out",
                "mlp.0": "linear_1", "mlp.3": "linear_2",
                "mlp.linear_1": "linear_1", "mlp.linear_2": "linear_2"}
_VIT_TOP = {"class_token": "class_token",
            "encoder.pos_embedding": "pos_embedding",
            "conv_proj.weight": "conv_proj.weight",
            "conv_proj.bias": "conv_proj.bias",
            "encoder.ln.weight": "ln.weight", "encoder.ln.bias": "ln.bias"}


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.float32)))


def load_torch_resnet(state_dict: Mapping[str, Any]) -> dict:
    """torchvision ResNet state_dict -> the port's ResNet state_dict.
    Classifier keys (``fc.*``) and ``num_batches_tracked`` are dropped (the
    backbone is truncated, ``models/resnet.py``)."""
    sd = {}
    for key, val in state_dict.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        if not _RESNET_KEY.fullmatch(key):
            raise ValueError(f"unhandled torch key: {key}")
        sd[key] = _tensor(val)
    return sd


def load_torch_vgg(state_dict: Mapping[str, Any]) -> dict:
    """torchvision VGG16 state_dict -> the port's VGG state_dict
    (``features.{i}.weight|bias``); classifier keys are dropped (the
    backbone is truncated after conv5_3)."""
    sd = {}
    for key, val in state_dict.items():
        if key.startswith("classifier."):
            continue
        if not _VGG_KEY.fullmatch(key):
            raise ValueError(f"unhandled torch key: {key}")
        sd[key] = _tensor(val)
    return sd


def load_torch_vit(state_dict: Mapping[str, Any]) -> dict:
    """torchvision VisionTransformer state_dict (``vit_b_16`` layout) ->
    the port's ViT state_dict (``models/vit.py``)."""
    sd = {}
    for key, val in state_dict.items():
        if key.startswith("heads."):
            continue
        if key in _VIT_TOP:
            sd[_VIT_TOP[key]] = _tensor(val)
            continue
        m = _VIT_LAYER.fullmatch(key)
        name, leaf = m.group(2).rsplit(".", 1) if m else (None, None)
        block = f"encoder_layer_{m.group(1)}." if m else ""
        if name == "self_attention" and leaf in ("in_proj_weight",
                                                 "in_proj_bias"):
            sd[block + "qkv." + leaf[len("in_proj_"):]] = _tensor(val)
        elif name in _VIT_MODULES and leaf in ("weight", "bias"):
            sd[block + _VIT_MODULES[name] + "." + leaf] = _tensor(val)
        else:
            raise ValueError(f"unhandled torch key: {key}")
    return sd


def validate_variables(model: torch.nn.Module, state_dict: Mapping) -> None:
    """Raise ``ValueError`` unless ``state_dict`` has exactly the model's
    keys (BatchNorm's step counters aside) and shapes. The model's own
    state_dict is the template by design, where the reference initializes
    Flax variables at an ``input_shape`` to compare with."""
    _check_fits(dict(state_dict), model)


def load_state_dict_checked(model: torch.nn.Module,
                            state_dict: Mapping) -> None:
    """Load an imported state_dict into ``model`` in place after
    ``validate_variables``; the model keeps its own step counters."""
    validate_variables(model, state_dict)
    model.load_state_dict(dict(state_dict), strict=False)
