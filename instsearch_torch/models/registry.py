"""Backbone registry: name -> (module factory, feature dim, stride)
(port of ``instsearch_tpu/models/registry.py``): the ResNet family, VGG-16
and the ViT patch-token backbones.

The port takes feature dims from here, never from
``ExtractConfig.descriptor_dim``, which imports the reference's Flax
registry."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.device import resolve_device
from .jax_import import load_jax_resnet, load_jax_vgg, load_jax_vit
from .resnet import resnet18, resnet34, resnet50, resnet101, resnet152
from .torch_import import load_state_dict_checked
from .vgg import VGG, vgg16
from .vit import ViT, vit_b_16, vit_l_16


class BackboneSpec(NamedTuple):
    """A backbone's factory, feature width and output stride. Its fields
    differ from the reference's by design: the reference's fourth,
    ``torch_loader``, converts a torchvision state_dict into Flax
    variables, and the port loads that state_dict as it is."""
    factory: Callable[..., Any]
    feature_dim: int
    stride: int


BACKBONES: dict[str, BackboneSpec] = {
    "resnet18": BackboneSpec(resnet18, 512, 32),
    "resnet34": BackboneSpec(resnet34, 512, 32),
    "resnet50": BackboneSpec(resnet50, 2048, 32),
    "resnet101": BackboneSpec(resnet101, 2048, 32),
    "resnet152": BackboneSpec(resnet152, 2048, 32),
    "vgg16": BackboneSpec(vgg16, 512, 16),
    # ViT patch-token backbones: stride = patch size; feature_dim = the
    # hidden dim of the token grid
    "vit_b_16": BackboneSpec(vit_b_16, 768, 16),
    "vit_l_16": BackboneSpec(vit_l_16, 1024, 16),
}


def get_backbone(name: str, dtype=torch.bfloat16,
                 attention: "str | None" = None, *, device=None):
    """-> ``(model, spec)``; the model is in eval mode, weights
    uninitialized (``init_weights`` or ``load_state_dict``), on ``device``:
    the CUDA card by default, raising without one. ``attention`` selects
    the ViT attention route (auto | xla | pallas | flash, ``models/vit.py``)
    and is ignored for the CNNs."""
    try:
        spec = BACKBONES[name]
    except KeyError:
        raise ValueError(f"unknown backbone {name!r}; expected one of "
                         f"{sorted(BACKBONES)}") from None
    device = resolve_device(device)
    if attention is not None and name.startswith("vit"):
        return spec.factory(dtype=dtype, attention=attention,
                            device=device), spec
    return spec.factory(dtype=dtype, device=device), spec


def load_variables(model: torch.nn.Module, variables) -> None:
    """Copy ``variables`` into ``model`` in place (checked, strict): the
    reference's Flax variables (a mapping with a ``"params"`` collection,
    carried by ``models.jax_import`` by the model's family), or a state_dict
    of the port's model (any other mapping). The caller's tensors are
    never the model's: ``load_state_dict`` copies."""
    if "params" not in variables:
        load_state_dict_checked(model, variables)
    elif isinstance(model, ViT):
        load_jax_vit(model, variables)
    elif isinstance(model, VGG):
        load_jax_vgg(model, variables)
    else:
        load_jax_resnet(model, variables)


def descriptor_dim(cfg) -> int:
    """Output width of an extraction config (``ExtractConfig``): the
    backbone's feature dim, or ``whiten_dim`` when whitening truncates."""
    if cfg.whiten and cfg.whiten_dim:
        return cfg.whiten_dim
    return BACKBONES[cfg.backbone].feature_dim
