"""Sequence-parallel ViT forward (port of ``instsearch_tpu/parallel/sp.py``).

DeepSpeed-Ulysses re-sharding (Jacobs et al., arXiv:2309.14509) over the
``'seq'`` axis of a mesh (devices may repeat; the axis may span
processes), forward only:

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
- Across processes (a mesh over a process group, ``parallel/mesh.py``)
  each process embeds its share and keeps its own token shards; where the
  other shards lie on other processes the two trades are one
  ``all_to_all`` each over the line's subgroup, and the final join of the
  token shards one ``all_gather``, so every process of the line finalizes
  the same output. The data positions' outputs meet by one
  ``all_gather``.

Constraint, as in the reference: ``num_heads % sp == 0``; any token count
works.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vit import ViT, attend, call_with, templates
from .mesh import axis_groups, batch_groups

_LAYER = "encoder_layer_"


def place_sp(mesh, *, model: ViT, axis: str = "seq") -> list:
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
    The result is on this process's first device of the mesh, on every
    process."""
    sp = mesh.shape[axis]
    if model.num_heads % sp:
        raise ValueError(f"num_heads={model.num_heads} not divisible by "
                         f"{axis}={sp} sequence shards")
    lines, n_data, data_mesh = batch_groups(mesh, axis, data_axis)
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
        s0 = devs.start
        tokens = F.pad(tokens, (0, 0, 0, pad))
        xs = [tokens[:, (s0 + j) * c:(s0 + j + 1) * c].to(dev)
              for j, dev in enumerate(devs)]
        masks = [torch.arange(n + pad, device=dev) < n for dev in devs]
        params = [layers(sd) for sd in variables_g]
        for i in range(model.num_layers):
            qkv = [call_with(block, params[j][i], "pre_attention", x)
                   for j, x in enumerate(xs)]           # [B, c, h, hd] each
            # token shard -> head shard: every token shard's q, k and v of
            # this process's heads, then all tokens of each local shard's
            blocks = _to_heads(qkv, devs, hl)
            o_heads = []
            for j, dev in enumerate(devs):
                q, k, v = (torch.cat([blk[u][:, :, j * hl:(j + 1) * hl]
                                      .to(dev) for blk in blocks],
                                     dim=1).transpose(1, 2)
                           for u in range(3))
                o_heads.append(attend(q, k, v, masks[j], model.dtype))
            # head shard -> token shard: every head shard's output at this
            # process's tokens, then each local shard's tokens, all heads
            hblocks = _to_tokens(o_heads, devs, c)
            new = []
            for j, dev in enumerate(devs):
                o = torch.cat([hb[:, :, j * c:(j + 1) * c].to(dev)
                               for hb in hblocks], dim=1)
                o = o.transpose(1, 2).reshape(b, c, d)
                new.append(call_with(block, params[j][i], "post_attention",
                                     xs[j], o))
            xs = new
        return devs.gather(xs, 1)[:, :n]

    def forward(variables, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        if b % n_data:
            raise ValueError(f"batch {b} not divisible by {n_data} data "
                             f"positions")
        share = b // n_data
        out = []
        for g, (pos, devs) in enumerate(lines):
            rest = {k: v for k, v in variables[g][0].items()
                    if not k.startswith(_LAYER)}
            tokens, (gh, gw) = call_with(
                shell, rest, "embed",
                images[pos * share:(pos + 1) * share].to(devs[0]))
            enc = encode(variables[g], devs, tokens)
            out.append(call_with(shell, rest, "finalize", enc, gh, gw))
        return (data_mesh.gather(out, 0) if data_mesh is not None
                else out[0])

    return forward


def _all_to_all(sends: list, group) -> list:
    """One ``all_to_all`` over ``group``: ``sends[q]`` (equal shapes) to
    process q, what each process sent this one back in rank order."""
    import torch.distributed as dist
    recvs = [torch.empty_like(t) for t in sends]
    dist.all_to_all(recvs, [t.contiguous() for t in sends], group=group)
    return recvs


def _to_heads(qkv: list, devs, hl: int) -> list:
    """The first trade: this process's local shards' ``(q, k, v)`` (``[B,
    c, h, hd]`` each) -> one ``(q, k, v)`` per global token shard, in order,
    of the heads this process's shards attend (``[B, c, len(devs) * hl,
    hd]``). In one process those are the shards' own tensors; across
    processes one ``all_to_all`` over the line's subgroup trades them."""
    if devs.group is None:
        return qkv
    nl, dev0 = len(devs), devs[0]
    w = nl * hl
    sends = [torch.stack([torch.cat([t[u][:, :, p * w:(p + 1) * w].to(dev0)
                                     for t in qkv], dim=1)
                          for u in range(3)])
             for p in range(devs.size // nl)]      # [3, B, nl c, nl hl, hd]
    c = qkv[0][0].shape[1]
    return [tuple(r[:, :, i * c:(i + 1) * c].unbind(0))
            for r in _all_to_all(sends, devs.group) for i in range(nl)]


def _to_tokens(o_heads: list, devs, c: int) -> list:
    """The second trade: this process's local head shards' outputs (``[B,
    hl, N, hd]`` each) -> one per global head shard, in order, at this
    process's tokens (``[B, hl, len(devs) * c, hd]``). In one process
    those are the shards' own outputs; across processes one
    ``all_to_all`` over the line's subgroup trades them."""
    if devs.group is None:
        return o_heads
    nl, dev0 = len(devs), devs[0]
    w = nl * c
    sends = [torch.cat([o[:, :, p * w:(p + 1) * w].to(dev0)
                        for o in o_heads], dim=1)
             for p in range(devs.size // nl)]      # [B, nl hl, nl c, hd]
    hl = o_heads[0].shape[1]
    return [r[:, i * hl:(i + 1) * hl]
            for r in _all_to_all(sends, devs.group) for i in range(nl)]
