"""Vision Transformer backbones, truncated before the classifier head (port
of ``instsearch_tpu/models/vit.py``).

Public layout is the reference's: NHWC images in, the patch-token grid
``[N, H/p, W/p, D]`` after the final LayerNorm out (the class token takes
part in attention and is dropped from the output), so GeM, MAC and average
pooling (``ops/pooling.py``) take it unchanged. Patchify is VALID: a side
that is not a multiple of the patch size loses its remainder. Position
embeddings are stored at the canonical ``image_size`` grid and resized
bilinearly (``ops/resize.py``, antialiased when shrinking, as
``jax.image.resize``) for any other grid, so multi-scale extraction works as
for the CNNs.

Numerics follow the reference: Linear layers and the patch convolution in
the model's ``dtype`` (bf16 by default); LayerNorms with eps 1e-6, f32
statistics and f32 output, cast back to ``dtype`` where the next layer
reads it; the class token and position embeddings are f32 parameters added
in ``dtype``; GELU is the exact erf form.

Attention routes (``attention``), as the reference's:
  * ``auto`` = ``xla``: ``attend``, plain matmuls; in bf16 the [B, h, N, N]
    logits stay bf16 and only the softmax runs in f32;
  * ``pallas``: K6, ``kernels.vit_attention.mha`` (f32 logits, whole rows);
  * ``flash``: K5, ``kernels.vit_attention.flash_mha`` (f32 logits, key
    tiles), the route for high-resolution extraction.
In f32 the three agree to rounding; in bf16 the kernel routes keep f32
logits where ``attend`` rounds them to bf16.

Module names follow the Flax tree (``conv_proj``, ``class_token``,
``pos_embedding``, ``encoder_layer_{i}.{ln_1, qkv, out, ln_2, linear_1,
linear_2}``, ``ln``), so ``models.jax_import.from_jax_vit`` is a mechanical
mapping.

Dosovitskiy et al., arXiv:2010.11929.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..kernels.vit_attention import flash_mha, mha
from ..ops.resize import resize_bilinear

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _resolve_attention(attention: str) -> str:
    """'auto' -> the plain matmul route, as the reference's; 'pallas' and
    'flash' are explicit opt-ins for the hand-written kernels."""
    if attention == "auto":
        return "xla"
    if attention not in ("xla", "pallas", "flash"):
        raise ValueError(
            f"attention must be auto|xla|pallas|flash, got {attention!r}")
    return attention


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           key_mask: "torch.Tensor | None", dtype) -> torch.Tensor:
    """Attention body of the plain route: ``q, k, v [B, h, N, hd]`` ->
    ``[B, h, N, hd]``. q is scaled BEFORE the product, the logits stay in
    the compute dtype, the softmax runs in f32 and is cast back before the
    product with v. ``key_mask`` (bool ``[N_k]`` or None) gives padded keys
    -inf logits."""
    att = torch.matmul(q / math.sqrt(q.shape[-1]), k.transpose(-1, -2))
    if key_mask is not None:
        att = att.masked_fill(~key_mask[None, None, None, :], float("-inf"))
    att = torch.softmax(att.float(), dim=-1).to(dtype)
    return torch.matmul(att, v)


class _LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-6) with f32 parameters, statistics and output over
    an input of any float dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__(dim, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: x + MHSA(LN(x)); x + MLP(LN(x)). The
    attention is split into ``pre_attention`` and ``post_attention`` as in
    the reference, whose sequence-parallel runtime re-shards between them."""

    def __init__(self, num_heads: int, mlp_dim: int, hidden_dim: int,
                 dtype=torch.bfloat16, attention: str = "auto", device=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden dim {hidden_dim} not divisible by "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.attention = _resolve_attention(attention)
        d = hidden_dim
        self.ln_1 = _LayerNorm(d, device)
        self.qkv = nn.Linear(d, 3 * d, dtype=dtype, device=device)
        self.out = nn.Linear(d, d, dtype=dtype, device=device)
        self.ln_2 = _LayerNorm(d, device)
        self.linear_1 = nn.Linear(d, mlp_dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(mlp_dim, d, dtype=dtype, device=device)

    def pre_attention(self, x: torch.Tensor):
        """LN1 + qkv projection: ``x [B, n, D]`` -> ``(q, k, v)`` each
        ``[B, n, h, hd]`` (head axis not yet transposed)."""
        y = self.ln_1(x).to(self.dtype)
        q, k, v = self.qkv(y).split(self.hidden_dim, dim=-1)
        b, n, _ = q.shape
        shp = (b, n, self.num_heads, self.hidden_dim // self.num_heads)
        return q.reshape(shp), k.reshape(shp), v.reshape(shp)

    def post_attention(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Out projection + residual + MLP; ``o [B, n, D]`` is the merged
        attention output."""
        x = x + self.out(o)
        y = self.linear_1(self.ln_2(x).to(self.dtype))
        return x + self.linear_2(F.gelu(y))          # exact erf GELU

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.hidden_dim:
            raise ValueError(f"input dim {x.shape[-1]} != "
                             f"hidden_dim {self.hidden_dim}")
        # [B, h, n, hd] views of the qkv projection; the kernels read them in
        # place and write o in [B, n, h, hd] memory, so the merge is a view
        q, k, v = (t.transpose(1, 2) for t in self.pre_attention(x))
        if self.attention == "pallas":
            o = mha(q, k, v)
        elif self.attention == "flash":
            o = flash_mha(q, k, v)
        else:
            o = attend(q, k, v, None, self.dtype)
        b, _, n, _ = o.shape
        o = o.transpose(1, 2).reshape(b, n, self.hidden_dim)
        return self.post_attention(x, o)


class ViT(nn.Module):
    """Truncated ViT: images [N,H,W,3] -> patch-token maps [N,H/p,W/p,D]."""

    def __init__(self, hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 patch_size: int = 16, image_size: int = 224,
                 dtype=torch.bfloat16, attention: str = "auto", device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.mlp_dim = mlp_dim
        self.patch_size = patch_size
        self.image_size = image_size
        self.dtype = dtype
        self.feature_dim = hidden_dim
        p = patch_size
        self.conv_proj = nn.Conv2d(3, hidden_dim, p, stride=p, dtype=dtype,
                                   device=device)
        g0 = image_size // p
        self.class_token = nn.Parameter(
            torch.zeros(1, 1, hidden_dim, device=device))
        self.pos_embedding = nn.Parameter(
            torch.zeros(1, 1 + g0 * g0, hidden_dim, device=device))
        for i in range(num_layers):
            setattr(self, f"encoder_layer_{i}",
                    EncoderBlock(num_heads, mlp_dim, hidden_dim, dtype=dtype,
                                 attention=attention, device=device))
        self.ln = _LayerNorm(hidden_dim, device)
        self.eval()

    def embed(self, x: torch.Tensor):
        """Patchify + class token + position embeddings: images ``[N, H, W,
        3]`` -> tokens ``[N, 1 + gh * gw, D]``, ``(gh, gw)``."""
        x = x.to(self.dtype)
        n, p, d = x.shape[0], self.patch_size, self.hidden_dim
        if x.shape[1] < p or x.shape[2] < p:
            raise ValueError(f"input {x.shape[1]}x{x.shape[2]} smaller than "
                             f"patch size {p}")
        x = self.conv_proj(x.permute(0, 3, 1, 2))      # [N, D, gh, gw]
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)                 # [N, gh * gw, D]

        g0 = self.image_size // p
        pos = self.pos_embedding
        cls_pos, grid_pos = pos[:, :1], pos[:, 1:]
        if (gh, gw) != (g0, g0):
            grid_pos = resize_bilinear(grid_pos.reshape(1, g0, g0, d),
                                       (gh, gw)).reshape(1, gh * gw, d)
        pos = torch.cat([cls_pos, grid_pos], dim=1)
        cls = self.class_token.to(self.dtype).expand(n, 1, d)
        return torch.cat([cls, x], dim=1) + pos.to(self.dtype), (gh, gw)

    def finalize(self, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        """Final LayerNorm, drop the class token, reshape to the NHWC patch
        grid."""
        x = self.ln(x)
        return x[:, 1:].reshape(x.shape[0], gh, gw,
                                self.hidden_dim).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, (gh, gw) = self.embed(x)
        for i in range(self.num_layers):
            x = getattr(self, f"encoder_layer_{i}")(x)
        return self.finalize(x, gh, gw)

    def init_weights(self, generator: torch.Generator) -> "ViT":
        """Flax's defaults: conv and Linear weights ``lecun_normal`` (normal
        truncated at two standard deviations, variance 1/fan_in), zero
        biases, LayerNorm weight 1 and bias 0, a zero class token, position
        embeddings ``normal(0.02)``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                    w = torch.empty(m.weight.shape, dtype=torch.float32,
                                    device=m.weight.device)
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    m.weight.copy_(w)
                    m.bias.zero_()
                elif isinstance(m, _LayerNorm):
                    m.reset_parameters()
            self.class_token.zero_()
            nn.init.normal_(self.pos_embedding, 0.0, 0.02,
                            generator=generator)
        return self


class _Bound(nn.Module):
    def __init__(self, module: nn.Module, method: str):
        super().__init__()
        self.m = module
        self.method = method

    def forward(self, *args):
        return getattr(self.m, self.method)(*args)


def call_with(module: nn.Module, params: dict, method: str, *args):
    """``module.<method>(*args)`` computed with ``params`` (names as in
    ``module.state_dict()``) in place of the module's own tensors, on the
    tensors' device (``torch.func.functional_call``): the model-parallel
    runtimes (``parallel/pp.py``, ``parallel/sp.py``, ``parallel/tp.py``)
    apply a template of shapes on the ``meta`` device to the weights they
    placed."""
    return functional_call(_Bound(module, method),
                           {"m." + k: v for k, v in params.items()}, args)


def templates(model: ViT) -> tuple[ViT, EncoderBlock]:
    """``model``'s embed/finalize part (no encoder layer) and one of its
    encoder blocks on the ``meta`` device, on the plain attention route:
    shapes only, for ``call_with``."""
    shell = ViT(model.hidden_dim, 0, model.num_heads, model.mlp_dim,
                model.patch_size, model.image_size, dtype=model.dtype,
                attention="xla", device="meta")
    block = EncoderBlock(model.num_heads, model.mlp_dim, model.hidden_dim,
                         dtype=model.dtype, attention="xla", device="meta")
    return shell, block


def vit_b_16(dtype=torch.bfloat16, attention: str = "auto",
             device=None) -> ViT:
    return ViT(hidden_dim=768, num_layers=12, num_heads=12, mlp_dim=3072,
               patch_size=16, dtype=dtype, attention=attention, device=device)


def vit_l_16(dtype=torch.bfloat16, attention: str = "auto",
             device=None) -> ViT:
    return ViT(hidden_dim=1024, num_layers=24, num_heads=16, mlp_dim=4096,
               patch_size=16, dtype=dtype, attention=attention, device=device)
