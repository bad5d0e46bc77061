"""Backbones of the port (ResNet and ViT families) and weight carry-over."""
from .jax_import import from_jax_resnet, from_jax_vit
from .registry import BACKBONES, BackboneSpec, get_backbone
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152
from .vit import ViT, vit_b_16, vit_l_16

__all__ = ["BACKBONES", "BackboneSpec", "get_backbone", "from_jax_resnet",
           "from_jax_vit", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "ViT", "vit_b_16", "vit_l_16"]
