"""Pipeline-parallel ViT forward (port of ``instsearch_tpu/parallel/pp.py``).

A GPipe schedule (Huang et al., arXiv:1811.06965), forward only: the L
encoder layers are cut into S = ``mesh.shape['pipe']`` contiguous stages
of L/S layers, each stage's layers on its device of the ``'pipe'`` axis
(devices may repeat: ``["cuda:0"] * 4`` runs the schedule on one card).

- ``stack_layer_params`` stacks each encoder-layer tensor over the layers
  (``[L, ...]``, named as in one block: ``qkv.weight``); ``place_pp``
  puts stage s's L/S rows of each stack on stage s's device and the rest
  (patch conv, class token, position embeddings, final LayerNorm) on the
  group's first device, where ``ViT.embed`` and ``ViT.finalize`` run,
  outside the pipeline.
- The batch is cut into ``n_micro`` microbatches. At step t (``n_micro + S
  - 1`` steps) stage s runs microbatch t - s through its layers, and the
  host enqueues the steps in that order, so stages on distinct cards
  overlap; the activation moves to the next stage's device between
  steps (the reference's ``ppermute``). Unlike the reference's SPMD
  program, the warm-up and drain steps compute nothing.
- Composed with a ``'data'`` axis, each position of it runs its own
  pipeline over its share of the batch (rows in order), weights placed
  per position.

The blocks are the model's own ``EncoderBlock`` on the plain attention
route, applied to the placed tensors through ``models.vit.call_with``.
"""
from __future__ import annotations

import torch

from ..models.vit import ViT, call_with, templates
from .mesh import axis_groups, batch_groups

_LAYER = "encoder_layer_"


def _check_layers(model: ViT, n_stages: int, axis: str) -> None:
    if model.num_layers % n_stages:
        raise ValueError(f"num_layers={model.num_layers} not divisible by "
                         f"{axis}={n_stages} pipeline stages")


def stack_layer_params(model: ViT) -> tuple[dict, dict]:
    """``(rest, stacked)``: ``stacked`` maps each tensor name of one
    encoder block (``qkv.weight``, ...) to its ``[L, ...]`` stack over the
    layers in order; ``rest`` is the rest of the state_dict (embed and
    finalize)."""
    sd = model.state_dict()
    rest = {k: v for k, v in sd.items() if not k.startswith(_LAYER)}
    first = f"{_LAYER}0."
    names = [k[len(first):] for k in sd if k.startswith(first)]
    stacked = {n: torch.stack([sd[f"{_LAYER}{i}.{n}"]
                               for i in range(model.num_layers)])
               for n in names}
    return rest, stacked


def place_pp(mesh, model: ViT, axis: str = "pipe") -> tuple[list, list]:
    """``(rest, stacked)``, one entry per position of the mesh's other axis
    (one on a 1-D mesh): ``rest[g]`` maps each embed/finalize tensor to
    its copy on the group's first device; ``stacked[g]`` maps each block
    tensor name to one ``[L/S, ...]`` tensor per stage, on its device (a
    view of the stack where the device is the model's own)."""
    n_stages = mesh.shape[axis]
    _check_layers(model, n_stages, axis)
    rest, stacked = stack_layer_params(model)
    per = model.num_layers // n_stages
    out_rest, out_stacked = [], []
    for devs in axis_groups(mesh, axis):
        out_rest.append({k: v.to(devs[0]) for k, v in rest.items()})
        out_stacked.append({k: tuple(v[s * per:(s + 1) * per].to(dev)
                                     for s, dev in enumerate(devs))
                            for k, v in stacked.items()})
    return out_rest, out_stacked


def pipelined_vit_fn(model: ViT, mesh, n_micro: int, axis: str = "pipe",
                     data_axis: "str | None" = None):
    """``f(rest, stacked, images) -> NHWC patch maps`` running the encoder
    stack as a GPipe pipeline over ``mesh[axis]`` (``rest, stacked`` from
    :func:`place_pp`); with a data axis (``'data'`` by default, when the
    mesh has one) each of its positions takes an equal share of the batch.
    The result is on the first group's first device."""
    n_stages = mesh.shape[axis]
    _check_layers(model, n_stages, axis)
    groups = batch_groups(mesh, axis, data_axis)
    shell, block = templates(model)
    per = model.num_layers // n_stages

    def layer(stacked_g, s, i):
        return {n: t[s][i] for n, t in stacked_g.items()}

    def forward(rest, stacked, images: torch.Tensor) -> torch.Tensor:
        b, n_g = images.shape[0], len(groups)
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        if b % (n_micro * n_g):
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro} "
                             f"x {n_g} data positions")
        share = b // n_g
        acts, grids = [], []
        for g, devs in enumerate(groups):
            tokens, grid = call_with(shell, rest[g], "embed",
                                     images[g * share:(g + 1) * share]
                                     .to(devs[0]))
            acts.append(list(tokens.chunk(n_micro)))
            grids.append(grid)
        params = [[[layer(stacked[g], s, i) for i in range(per)]
                   for s in range(n_stages)] for g in range(n_g)]
        for t in range(n_micro + n_stages - 1):
            for g, devs in enumerate(groups):
                for s in range(n_stages):
                    m = t - s
                    if not 0 <= m < n_micro:
                        continue
                    h = acts[g][m].to(devs[s])          # the ppermute
                    for p in params[g][s]:
                        h = call_with(block, p, "forward", h)
                    acts[g][m] = h
        out = []
        for g, devs in enumerate(groups):
            enc = torch.cat([a.to(devs[0]) for a in acts[g]])
            out.append(call_with(shell, rest[g], "finalize", enc,
                                 *grids[g]).to(groups[0][0]))
        return torch.cat(out)

    return forward
