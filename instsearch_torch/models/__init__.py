"""Backbones of the port (ResNet family) and weight carry-over."""
from .jax_import import from_jax_resnet
from .registry import BACKBONES, BackboneSpec, get_backbone
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152

__all__ = ["BACKBONES", "BackboneSpec", "get_backbone", "from_jax_resnet",
           "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]
