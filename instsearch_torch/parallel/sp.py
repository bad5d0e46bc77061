"""Sequence-parallel ViT forward (port of ``instsearch_tpu/parallel/sp.py``).

DeepSpeed-Ulysses re-sharding (Jacobs et al., arXiv:2309.14509) over the
``'seq'`` axis of a one-process mesh (devices may repeat), forward only:

- The tokens (class token included) are padded to a multiple of sp and cut
  into sp contiguous shards, one a device. Every token-local stage (the
  LayerNorms, the qkv and out projections, the MLP) runs on its shard's
  N/sp tokens with replicated weights.
- Attention needs every (query, key) pair, so each block trades the token
  shards for head shards (the first all-to-all: shard j gets all N tokens
  of heads ``j h/sp .. (j+1) h/sp - 1``), attends, and trades back (the
  second). On one card the shards' attention runs in turn, so the ``[B,
  h/sp, N, N]`` logits of one shard are live at a time.
- The padded keys are masked: ``models.vit.attend`` gives them -inf logits
  before its f32 softmax, so the result equals the unpadded computation;
  the padded rows are dropped before ``ViT.finalize``.
- ``ViT.embed`` and ``ViT.finalize`` run on the group's first device,
  outside the loop; the blocks are the model's own ``pre_attention`` /
  ``attend`` / ``post_attention`` on the plain route, applied to the placed
  tensors through ``models.vit.call_with``.
- Composed with a ``'data'`` axis, each position of it runs the sequence
  split over its share of the batch.

Constraint, as in the reference: ``num_heads % sp == 0``; any token count
works.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vit import ViT, attend, call_with, templates
from .mesh import axis_groups, batch_groups

_LAYER = "encoder_layer_"


def place_sp(mesh, model: ViT, axis: str = "seq") -> list:
    """Replicated weights: one entry per position of the mesh's other axis
    (one on a 1-D mesh), each a tuple with ``model``'s state_dict on every
    device of the group's ``axis`` (one copy a distinct device, shared
    where devices repeat)."""
    sd = model.state_dict()
    out = []
    for devs in axis_groups(mesh, axis):
        copies = {}
        out.append(tuple(copies.setdefault(
            torch.empty(0, device=dev).device,
            {k: v.to(dev) for k, v in sd.items()}) for dev in devs))
    return out


def sequence_parallel_vit_fn(model: ViT, mesh, axis: str = "seq",
                             data_axis: "str | None" = None):
    """``f(variables, images) -> NHWC patch maps`` running the encoder with
    the token axis sharded over ``mesh[axis]`` (``variables`` from
    :func:`place_sp`); with a data axis (``'data'`` by default, when the
    mesh has one) each of its positions takes an equal share of the batch.
    The result is on the first group's first device."""
    sp = mesh.shape[axis]
    if model.num_heads % sp:
        raise ValueError(f"num_heads={model.num_heads} not divisible by "
                         f"{axis}={sp} sequence shards")
    groups = batch_groups(mesh, axis, data_axis)
    shell, block = templates(model)
    hl, d = model.num_heads // sp, model.hidden_dim

    def layers(sd):
        out = []
        for i in range(model.num_layers):
            pre = f"{_LAYER}{i}."
            out.append({k[len(pre):]: v for k, v in sd.items()
                        if k.startswith(pre)})
        return out

    def encode(variables_g, devs, tokens):
        b, n, _ = tokens.shape
        pad = -n % sp
        c = (n + pad) // sp
        tokens = F.pad(tokens, (0, 0, 0, pad))
        xs = [tokens[:, j * c:(j + 1) * c].to(dev)
              for j, dev in enumerate(devs)]
        masks = [torch.arange(n + pad, device=dev) < n for dev in devs]
        params = [layers(sd) for sd in variables_g]
        for i in range(model.num_layers):
            qkv = [call_with(block, params[j][i], "pre_attention", x)
                   for j, x in enumerate(xs)]           # [B, c, h, hd] each
            o_heads = []
            for j, dev in enumerate(devs):
                # token shard -> head shard: all tokens of this shard's heads
                q, k, v = (torch.cat([t[u][:, :, j * hl:(j + 1) * hl].to(dev)
                                      for t in qkv], dim=1).transpose(1, 2)
                           for u in range(3))
                o_heads.append(attend(q, k, v, masks[j], model.dtype))
            new = []
            for j, dev in enumerate(devs):
                # head shard -> token shard: this shard's tokens, all heads
                o = torch.cat([oh[:, :, j * c:(j + 1) * c].to(dev)
                               for oh in o_heads], dim=1)
                o = o.transpose(1, 2).reshape(b, c, d)
                new.append(call_with(block, params[j][i], "post_attention",
                                     xs[j], o))
            xs = new
        return torch.cat([x.to(devs[0]) for x in xs], dim=1)[:, :n]

    def forward(variables, images: torch.Tensor) -> torch.Tensor:
        b, n_g = images.shape[0], len(groups)
        if b % n_g:
            raise ValueError(f"batch {b} not divisible by {n_g} data "
                             f"positions")
        share = b // n_g
        out = []
        for g, devs in enumerate(groups):
            rest = {k: v for k, v in variables[g][0].items()
                    if not k.startswith(_LAYER)}
            tokens, (gh, gw) = call_with(
                shell, rest, "embed",
                images[g * share:(g + 1) * share].to(devs[0]))
            enc = encode(variables[g], devs, tokens)
            out.append(call_with(shell, rest, "finalize", enc, gh, gw)
                       .to(groups[0][0]))
        return torch.cat(out)

    return forward
