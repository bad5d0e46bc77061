"""ResNet backbones, truncated before the classifier (port of
``instsearch_tpu/models/resnet.py``).

Public layout is the reference's: NHWC images in, NHWC feature maps out.
Inside, activations run in ``torch.channels_last`` (NHWC in memory), which
is the layout cuDNN's fast convolutions take. Convolutions compute in the
model's ``dtype`` (bf16 by default); BatchNorm keeps f32 parameters and runs
in inference mode (eps 1e-5), as the Flax model's ``use_running_average``.
Module names follow torchvision's state_dict (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1..3}``, ``downsample.{0,1}``), so
``models.jax_import.from_jax_resnet`` and torchvision checkpoints load with
``load_state_dict``.

He et al., arXiv:1512.03385.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class _BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm with f32 parameters over an activation of any
    float dtype; the output keeps the activation's dtype."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, kernel: int, stride: int, padding: int,
          dtype, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                     bias=False, dtype=dtype, device=device)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34), expansion 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, dtype, device)
        self.bn1 = _BatchNorm(planes, device)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype, device)
        self.bn2 = _BatchNorm(planes, device)
        self.downsample = (nn.Sequential(
            _conv(inplanes, planes, 1, stride, 0, dtype, device),
            _BatchNorm(planes, device)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck block with expansion 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        out = planes * 4
        self.conv1 = _conv(inplanes, planes, 1, 1, 0, dtype, device)
        self.bn1 = _BatchNorm(planes, device)
        self.conv2 = _conv(planes, planes, 3, stride, 1, dtype, device)
        self.bn2 = _BatchNorm(planes, device)
        self.conv3 = _conv(planes, out, 1, 1, 0, dtype, device)
        self.bn3 = _BatchNorm(out, device)
        self.downsample = (nn.Sequential(
            _conv(inplanes, out, 1, stride, 0, dtype, device),
            _BatchNorm(out, device)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNet(nn.Module):
    """Truncated ResNet: images [N,H,W,3] -> feature maps [N,H/32,W/32,C].

    No avgpool / fc head: pooling is the descriptor layer's job
    (``instsearch_torch.ops.pooling``)."""

    def __init__(self, stage_sizes: Sequence[int], block=Bottleneck,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype, device)
        self.bn1 = _BatchNorm(64, device)
        inplanes = 64
        for i, (feats, blocks) in enumerate(zip((64, 128, 256, 512),
                                                stage_sizes)):
            stride = 1 if i == 0 else 2
            layer = []
            for j in range(blocks):
                # torchvision: BasicBlock stages only downsample when the
                # shape changes (stage 1 of resnet18/34 has identity skips)
                needs_ds = j == 0 and (block is Bottleneck or stride != 1
                                       or inplanes != feats)
                layer.append(block(inplanes, feats,
                                   stride=stride if j == 0 else 1,
                                   downsample=needs_ds, dtype=dtype,
                                   device=device))
                inplanes = feats * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.feature_dim = inplanes
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype,
                                     memory_format=torch.channels_last)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.permute(0, 2, 3, 1)             # NHWC view, no copy

    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """Flax's defaults: conv kernels ``lecun_normal`` (normal truncated
        at two standard deviations, variance 1/fan_in); BatchNorm scale 1,
        bias 0, mean 0, var 1 — a random network with the reference's
        activation scale."""
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
                elif isinstance(m, _BatchNorm):
                    m.reset_parameters()
        return self


def resnet18(dtype=torch.bfloat16, device=None) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, dtype, device)


def resnet34(dtype=torch.bfloat16, device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, dtype, device)


def resnet50(dtype=torch.bfloat16, device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, dtype, device)


def resnet101(dtype=torch.bfloat16, device=None) -> ResNet:
    return ResNet((3, 4, 23, 3), Bottleneck, dtype, device)


def resnet152(dtype=torch.bfloat16, device=None) -> ResNet:
    return ResNet((3, 8, 36, 3), Bottleneck, dtype, device)
