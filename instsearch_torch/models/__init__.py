"""Backbones of the port (ResNet, VGG and ViT families) and weight
carry-over from the reference's Flax variables and from torchvision
checkpoints."""
from .jax_import import from_jax_resnet, from_jax_vgg, from_jax_vit
from .registry import BACKBONES, BackboneSpec, get_backbone
from .torch_import import (load_torch_resnet, load_torch_vgg, load_torch_vit,
                           validate_variables)
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152
from .vgg import VGG, vgg16
from .vit import ViT, vit_b_16, vit_l_16

__all__ = ["BACKBONES", "BackboneSpec", "get_backbone", "from_jax_resnet",
           "from_jax_vgg", "from_jax_vit", "load_torch_resnet",
           "load_torch_vgg", "load_torch_vit", "validate_variables",
           "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "VGG", "vgg16", "ViT", "vit_b_16", "vit_l_16"]
