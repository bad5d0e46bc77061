"""VGG backbone truncated after conv5_3's ReLU (port of
``instsearch_tpu/models/vgg.py``).

The MAC/R-MAC literature (arXiv:1511.05879) pools the last convolution's
post-ReLU activations, conv5_3 at stride 16, so the final max-pool and the
classifier are dropped. Public layout is the reference's: NHWC images in,
NHWC feature maps out; inside, activations run in ``torch.channels_last``,
the layout cuDNN's fast convolutions take. Module names follow
torchvision's ``features.{idx}`` (a convolution and its ReLU take one index
each, a max-pool one), so ``models.jax_import.from_jax_vgg`` and
torchvision checkpoints load with ``load_state_dict``. Convolutions and
their biases are in the model's ``dtype`` (bf16 by default), as the Flax
module casts its f32 parameters to its dtype.

Simonyan & Zisserman, arXiv:1409.1556.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn

# torchvision vgg16.features: output channels of each convolution, "M" for
# a 2x2 max-pool
VGG16_CFG: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                    512, 512, 512, "M", 512, 512, 512)


class VGG(nn.Module):
    """Images [N,H,W,3] -> conv5_3 feature maps [N,H/16,W/16,C] (each
    max-pool floors an odd side)."""

    def __init__(self, cfg: Sequence = VGG16_CFG, dtype=torch.bfloat16,
                 *, device=None):
        super().__init__()
        self.dtype = dtype
        layers: list[nn.Module] = []
        cin = 3
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1, dtype=dtype,
                                     device=device), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        self.feature_dim = cin
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype,
                                     memory_format=torch.channels_last)
        return self.features(x).permute(0, 2, 3, 1)   # NHWC view, no copy

    def init_weights(self, generator: torch.Generator) -> "VGG":
        """Flax's defaults: kernels ``lecun_normal`` (normal truncated at
        two standard deviations, variance 1/fan_in), biases zero."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                    # 0.8796 = std of a standard normal truncated to [-2, 2]
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    w = torch.empty(m.weight.shape, dtype=torch.float32,
                                    device=m.weight.device)
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    m.weight.copy_(w)
                    m.bias.zero_()
        return self


def vgg16(dtype=torch.bfloat16, *, device=None) -> VGG:
    return VGG(VGG16_CFG, dtype, device=device)
